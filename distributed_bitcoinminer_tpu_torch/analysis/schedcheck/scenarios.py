"""dbmcheck scenario catalog.

Seventeen REAL control-plane scenarios — the gate explores these — and
two KNOWN-BAD fixtures (deliberately racy mini-schedulers the explorer
must be able to catch; they pin the checker's own sensitivity and are
never part of the gate's clean-run requirement).

Every scenario draws its constants (ranges, delays, which miner wedges)
from the seed's ``Random`` stream, so each seed is both a schedule AND a
slightly different population — a random walk covers timing races the
pure step-ordering branching cannot reach (e.g. a lease expiring one
tick before vs after a Result lands).

Run-time randomness (per-chunk delays, fake compute costs) is drawn
from PER-ACTOR child streams forked off the scenario stream at build
time (:func:`_fork`), never from the shared stream: a shared stream's
draw ORDER would follow the explored schedule, so a shrink/DFS
perturbation of one choice would silently re-roll every later actor's
timing — conflating ordering changes with population changes. With
per-actor streams, an actor's k-th draw depends only on its own k,
which is what makes shrinking converge on the ordering change alone.
(Exact-spec replay is bit-exact either way.)
"""

from __future__ import annotations

import asyncio
import os
import random

from ...apps.scheduler import Scheduler
from ...utils._env import str_env
from ...bitcoin.hash import hash_op
from ...bitcoin.message import (Message, MsgType, new_join, new_request,
                                new_result)
from ...lsp.errors import LspError
from ...utils.config import (CacheParams, CoalesceParams, LeaseParams,
                             QosParams, StripeParams, VerifyParams)
from .scenario import Ctx, Req, Scenario, oracle_min

__all__ = ["SCENARIOS", "FIXTURES", "ALL"]

_DATA = ("alpha", "bravo", "charlie", "delta")


#: The verification tier every scheduler of a scenario runs unless the
#: scenario turns it on itself: ``VerifyParams()`` (claim checks, no
#: audits). A scheduler left to ``verify_from_env`` would audit 2% of its
#: chunks (``DBMT_AUDIT_P``) with an unseeded stream, and a schedule
#: would stop being a function of its seed spec.
_STOCK_VERIFY = VerifyParams()


def _fork(rng: random.Random) -> random.Random:
    """A child stream forked from ``rng`` at build time (see module
    docstring: run-time draws must come from per-actor streams)."""
    return random.Random(rng.getrandbits(64))


def _make_sched(ctx: Ctx, lease: LeaseParams, qos: QosParams,
                stripe: StripeParams = None,
                coalesce: CoalesceParams = None,
                adapt=None, verify=None, audit_rng=None) -> Scheduler:
    # No clock argument: the port's scheduler, its admission buckets and
    # its adapt controllers read ``time.monotonic`` at each call, which
    # the harness patches to the VIRTUAL clock. ``verify``/``audit_rng``:
    # the byzantine family turns the verification tier on with a seeded
    # audit stream (the _fork discipline — audit coin flips and
    # subwindow draws come from a per-scheduler child stream, never
    # global RNG state); everyone else runs the stock default.
    from ...utils.config import AdaptParams
    sched = Scheduler(
        ctx.server, lease=lease, cache=CacheParams(),
        stripe=stripe if stripe is not None
        else StripeParams(enabled=False), qos=qos,
        coalesce=coalesce if coalesce is not None
        else CoalesceParams(enabled=False),
        adapt=adapt if adapt is not None
        else AdaptParams(enabled=False),
        verify=verify if verify is not None else _STOCK_VERIFY,
        audit_rng=audit_rng)
    ctx.sched = sched
    ctx.spawn(sched.run())
    return sched


async def _warm_rates(ctx: Ctx, n_miners: int, rate: float) -> None:
    """Wait for every miner to join, then pin the throughput EWMAs —
    the striping/QoS-chunking planes need a warm pool, and warming via
    real traffic would couple the scenario's shape to its schedule."""
    while ctx.sched is None or len(ctx.sched.miners) < n_miners:
        await asyncio.sleep(0.01)
    for m in ctx.sched.miners:
        m.rate_ewma = rate
    ctx.sched.miner_plane.pool_rate = rate


# ------------------------------------------------------------ lease_reissue

class LeaseReissue(Scenario):
    """A wedged miner's lease blows mid-request; the chunk is
    speculatively re-issued and first-Result-wins dedup must keep the
    merge exactly-once — raced against parked-chunk recovery, client
    drops, and quarantine. Stock FIFO path (QoS off), so the reference
    one-in-flight reply order is asserted globally."""

    name = "lease_reissue"

    def build(self, ctx: Ctx) -> None:
        rng = ctx.rng
        _make_sched(ctx, lease=LeaseParams(
            grace_s=0.4, factor=4.0, floor_s=0.3, tick_s=0.05,
            quarantine_after=rng.choice((1, 2)), ewma_alpha=0.3,
            queue_alarm_s=30.0), qos=QosParams(enabled=False))
        # One miner may misbehave: WEDGE (reads forever, never answers
        # — pure lease blow) or go SLOW (answers after its lease blew —
        # the first-Result-wins dedup race, dup_results > 0).
        bad = rng.choice((None, 0, 1, 2))
        slow = rng.random() < 0.5
        for i in range(3):
            kw = {}
            mrng = _fork(rng)
            if bad == i and not slow:
                kw["wedge_after"] = rng.choice((0, 1))
            if bad == i and slow:
                kw["delay_fn"] = \
                    lambda size, r=mrng: r.uniform(0.8, 2.0)
            else:
                kw.setdefault(
                    "delay_fn",
                    lambda size, r=mrng: r.uniform(0.02, 0.25))
            ctx.add_miner(f"m{i}", **kw)
        reqs = []
        for j in range(rng.choice((2, 3))):
            # Unique cache keys (the "#j" suffix): a duplicate would
            # legitimately replay from the ResultCache at arrival and
            # overtake the FIFO, which the global-FIFO check below
            # deliberately does not model.
            reqs.append(Req(f"{rng.choice(_DATA)}#{j}", 0,
                            rng.choice((59, 119, 199)),
                            pre_delay=rng.uniform(0.0, 0.3)))
        ctx.add_client("c0", reqs)
        if rng.random() < 0.5:
            # A second client that drops right after sending: the
            # cancel path must free the pool without corrupting c0.
            ctx.add_client("c1", [Req(f"{rng.choice(_DATA)}#x", 0, 99,
                                      pre_delay=rng.uniform(0.0, 0.4),
                                      close_after=True)])

    def check(self, ctx: Ctx):
        out = self.check_replies(ctx)
        out += self.check_global_fifo(ctx)
        out += self.check_accounting(ctx)
        return out


# ---------------------------------------------------------------- qos_shed

class QosShed(Scenario):
    """The fair-share plane under contention: a chunked elephant
    interleaving with mice from two other tenants, token-bucket
    admission (virtual-clock bucket) and oldest-first overload shedding
    both able to fire. Every surviving request must merge exactly-once
    oracle-exact in per-tenant order; shed tenants must see their conn
    die and nothing else corrupt; the grant accounting must return to
    zero."""

    name = "qos_shed"

    def build(self, ctx: Ctx) -> None:
        rng = ctx.rng
        sched = _make_sched(ctx, lease=LeaseParams(
            grace_s=5.0, factor=4.0, floor_s=2.0, tick_s=0.1,
            queue_alarm_s=30.0), qos=QosParams(
            enabled=True, chunk_s=0.2, max_chunks=32, depth=2,
            wholesale_s=0.5, max_queued=rng.choice((3, 4)),
            rate=rng.choice((0.0, 0.5)), burst=2.0))
        for i in range(2):
            ctx.add_miner(
                f"m{i}",
                delay_fn=lambda size, r=_fork(rng):
                    size / 1000.0 * r.uniform(0.8, 1.2))
        ctx.spawn(_warm_rates(ctx, 2, 1000.0))
        # Tenant 1: the elephant (estimated 1s > wholesale_s 0.5 at the
        # warmed 2x1000 nps pool -> chunked activation, ~10 chunks).
        ctx.add_client("elephant", [
            Req(rng.choice(_DATA), 0, 1999, pre_delay=0.5)])
        # Tenants 2 + 3: mice trains; pre-delays land them against the
        # elephant's grant stream (and sometimes over the admission
        # burst of 2, or the max_queued bound).
        for t, n in (("mice_a", 3), ("mice_b", 2)):
            reqs = [Req(rng.choice(_DATA), 0, rng.choice((99, 149)),
                        pre_delay=0.5 + rng.uniform(0.0, 1.5))
                    for _ in range(n)]
            ctx.add_client(t, reqs)
        self.sched = sched

    def check(self, ctx: Ctx):
        out = self.check_replies(ctx)
        out += self.check_accounting(ctx)
        # Shed bookkeeping: a script that saw its conn die must be
        # matched by at least one counted shed (and vice versa a shed
        # count with no dead conn would mean we closed nobody).
        shed_conns = sum(1 for c in ctx.clients if c.shed)
        shed_count = ctx.sched.stats["qos_shed"]
        if shed_conns and not shed_count:
            out.append(f"{shed_conns} client conn(s) died without any "
                       f"counted QoS shed")
        if shed_count and not shed_conns and \
                not any(c.dropped for c in ctx.clients):
            out.append(f"qos_shed counted {shed_count} but no client "
                       f"conn died")
        return out


# ------------------------------------------------------- pipelined_dispatch

class _FakeSearcher:
    """Two-phase (dispatch/finalize) oracle searcher for the REAL
    MinerWorker pipeline: compute cost is charged to the virtual clock
    inside the executor step (the loop thread is blocked, so the jump
    is atomic), sized so the scheduler's stripe planner produces
    multi-chunk shares."""

    def __init__(self, data: str, ctx: Ctx, rng: random.Random,
                 rate: float = 4000.0):
        self.data = data
        self.ctx = ctx
        self.rng = rng          # per-searcher stream (module docstring)
        self.rate = rate

    def _charge(self, size: int, frac: float = 1.0) -> None:
        self.ctx.loop.advance(
            size / self.rate * frac * self.rng.uniform(0.7, 1.3))

    def search(self, lower: int, upper: int):
        self._charge(upper - lower + 1)
        return oracle_min(self.data, lower, upper)

    def search_until(self, lower: int, upper: int, target: int):
        from .scenario import oracle_until
        self._charge(upper - lower + 1)
        return oracle_until(self.data, lower, upper, target)

    def dispatch(self, lower: int, upper: int):
        self._charge(upper - lower + 1, frac=0.2)   # async enqueue cost
        return (lower, upper)

    def finalize(self, handle, lower: int):
        lo, up = handle
        self._charge(up - lo + 1, frac=0.8)         # force cost
        return oracle_min(self.data, lo, up)

    def dispatch_batch(self, entries):
        """Batched-dispatch contract: one 'launch' for many
        jobs, charged as a single compute interval — the coalesced
        shape the batched_dispatch scenario drives through the REAL
        miner executor."""
        for _s, lo, up in entries:
            if lo > up:
                raise ValueError("empty range")
        self._charge(sum(up - lo + 1 for _s, lo, up in entries),
                     frac=0.2)
        return [(s.data, lo, up) for s, lo, up in entries]

    def finalize_batch(self, handle):
        self._charge(sum(up - lo + 1 for _d, lo, up in handle), frac=0.8)
        return [oracle_min(d, lo, up) for d, lo, up in handle]


class PipelinedDispatch(Scenario):
    """The REAL miner-side dispatch pipeline (apps/miner.MinerWorker,
    reader task + overlapped two-phase executor + to_thread hops) under
    the REAL striping scheduler: Results must still land strictly in
    request order per miner, and every merge stays exactly-once."""

    name = "pipelined_dispatch"
    #: The searcher each worker's factory builds, ``cls(data, ctx, rng)``
    #: (a subclass swaps it: the card phase runs the kernels here).
    SEARCHER = _FakeSearcher

    def build(self, ctx: Ctx) -> None:
        from ...apps.miner import MinerWorker
        rng = ctx.rng
        _make_sched(ctx, lease=LeaseParams(
            grace_s=5.0, factor=4.0, floor_s=2.0, tick_s=0.1,
            queue_alarm_s=30.0), qos=QosParams(enabled=False),
            stripe=StripeParams(enabled=True, chunk_s=0.1, depth=4))
        self.workers = []
        for i in range(2):
            chan = ctx.server.connect()
            wrng = _fork(rng)
            worker = MinerWorker(
                f"det:{i}",
                searcher_factory=lambda data, batch=None, r=wrng:
                    self.SEARCHER(data, ctx, _fork(r)),
                pipeline=True, pipeline_depth=rng.choice((2, 4)))
            worker.client = chan
            chan.write(new_join().to_json())
            ctx.spawn(worker.run())
            self.workers.append((worker, chan))
        ctx.spawn(_warm_rates(ctx, 2, 4000.0))
        reqs = []
        for j in range(rng.choice((2, 3))):
            reqs.append(Req(f"{rng.choice(_DATA)}#{j}", 0,
                            rng.choice((799, 1199, 1599)),
                            pre_delay=0.5 + 0.2 * j))
        ctx.add_client("c0", reqs)

    def check(self, ctx: Ctx):
        out = self.check_replies(ctx)
        out += self.check_global_fifo(ctx)
        out += self.check_accounting(ctx)
        # In-order pipeline contract: each miner's k-th Result answers
        # its k-th Request (oracle-checked — a pipelined executor that
        # let chunk k+1 overtake chunk k would mismatch here).
        for worker, chan in self.workers:
            asked = [Message.from_json(p)
                     for p in ctx.server.sent_to(chan.conn_id)]
            asked = [m for m in asked if m.type == MsgType.REQUEST]
            answered = [Message.from_json(p) for p in chan.sent]
            answered = [m for m in answered if m.type == MsgType.RESULT]
            for k, rep in enumerate(answered):
                if k >= len(asked):
                    out.append(f"miner conn {chan.conn_id}: more "
                               f"Results than Requests")
                    break
                req = asked[k]
                h, n = oracle_min(req.data, req.lower, req.upper)
                if (rep.hash, rep.nonce) != (h, n):
                    out.append(
                        f"miner conn {chan.conn_id}: Result #{k} "
                        f"({rep.hash}, {rep.nonce}) does not answer "
                        f"Request #{k} [{req.lower}, {req.upper}] "
                        f"(oracle ({h}, {n})) — pipeline reordered "
                        f"Results")
        return out


# ------------------------------------------------------- batched_dispatch

class BatchedDispatch(Scenario):
    """Cross-request batched dispatch under the REAL
    scheduler/QoS and REAL coalescing MinerWorkers: a chunked elephant
    plus mice trains from two other tenants, the scheduler's coalescing
    window stacking small grants on one miner, and the miner executor
    draining them into shared batched launches. Every reply must stay
    exactly-once oracle-exact in per-tenant order, the grant accounting
    must balance, and each miner's k-th Result must answer its k-th
    Request — a coalescer that scattered batch results out of drain
    order, or attributed them to the wrong request, fails here."""

    name = "batched_dispatch"
    #: As :attr:`PipelinedDispatch.SEARCHER`.
    SEARCHER = _FakeSearcher

    def build(self, ctx: Ctx) -> None:
        from ...apps.miner import MinerWorker
        rng = ctx.rng
        lanes = rng.choice((3, 4, 8))
        _make_sched(ctx, lease=LeaseParams(
            grace_s=5.0, factor=4.0, floor_s=2.0, tick_s=0.1,
            queue_alarm_s=30.0), qos=QosParams(
            enabled=True, chunk_s=0.2, max_chunks=32, depth=2,
            wholesale_s=0.5),
            coalesce=CoalesceParams(
                enabled=True, lanes=lanes,
                small_s=rng.choice((0.1, 0.25))))
        self.workers = []
        for i in range(2):
            chan = ctx.server.connect()
            wrng = _fork(rng)
            worker = MinerWorker(
                f"det:{i}",
                searcher_factory=lambda data, batch=None, r=wrng:
                    self.SEARCHER(data, ctx, _fork(r)),
                pipeline=True, pipeline_depth=8,
                coalesce=True, coalesce_lanes=lanes,
                coalesce_max=1 << 20)
            worker.client = chan
            chan.write(new_join().to_json())
            ctx.spawn(worker.run())
            self.workers.append((worker, chan))
        ctx.spawn(_warm_rates(ctx, 2, 4000.0))
        # Tenant 1: a chunked elephant (est 2s > wholesale 0.5s at the
        # warmed 2 x 4000 nps pool) whose grant stream the mice must
        # interleave — and sometimes share windows — with.
        ctx.add_client("elephant", [
            Req(rng.choice(_DATA), 0, rng.choice((7999, 11999)),
                pre_delay=0.5)])
        # Tenants 2 + 3: mice trains of small argmin requests (each one
        # QoS chunk, each coalescible at the warmed rate) landing while
        # the elephant is mid-grant.
        for t, n in (("mice_a", rng.choice((2, 3))), ("mice_b", 2)):
            reqs = [Req(f"{rng.choice(_DATA)}#{t}{j}", 0,
                        rng.choice((99, 199, 399)),
                        pre_delay=0.6 + rng.uniform(0.0, 1.0))
                    for j in range(n)]
            ctx.add_client(t, reqs)

    def check(self, ctx: Ctx):
        out = self.check_replies(ctx)
        out += self.check_accounting(ctx)
        # In-order coalesced scatter: each miner's k-th Result answers
        # its k-th Request, oracle-exact (same contract as the
        # pipelined_dispatch scenario — a batch written out of drain
        # order, or mis-scattered across requests, mismatches here).
        for worker, chan in self.workers:
            asked = [Message.from_json(p)
                     for p in ctx.server.sent_to(chan.conn_id)]
            asked = [m for m in asked if m.type == MsgType.REQUEST]
            answered = [Message.from_json(p) for p in chan.sent]
            answered = [m for m in answered if m.type == MsgType.RESULT]
            for k, rep in enumerate(answered):
                if k >= len(asked):
                    out.append(f"miner conn {chan.conn_id}: more "
                               f"Results than Requests")
                    break
                req = asked[k]
                h, n = oracle_min(req.data, req.lower, req.upper)
                if (rep.hash, rep.nonce) != (h, n):
                    out.append(
                        f"miner conn {chan.conn_id}: Result #{k} "
                        f"({rep.hash}, {rep.nonce}) does not answer "
                        f"Request #{k} [{req.lower}, {req.upper}] "
                        f"(oracle ({h}, {n})) — coalescer broke the "
                        f"in-order scatter")
        return out


# ------------------------------------------------------- difficulty_prefix

class DifficultyPrefix(Scenario):
    """Difficulty (first-hit) merges under re-issue and stock-miner
    degradation: the prefix-release rule must hand back the globally
    FIRST qualifying nonce when every miner speaks the extension, and
    at-least-a-qualifying nonce when a stock miner weakened the merge —
    never a non-qualifying or fabricated one."""

    name = "difficulty_prefix"

    def build(self, ctx: Ctx) -> None:
        rng = ctx.rng
        _make_sched(ctx, lease=LeaseParams(
            grace_s=0.5, factor=4.0, floor_s=0.3, tick_s=0.05,
            quarantine_after=2, queue_alarm_s=30.0),
            qos=QosParams(enabled=False))
        self.has_stock = rng.random() < 0.5
        wedged = rng.choice((None, 0, 1, 2))
        for i in range(3):
            kw = {}
            if wedged == i:
                kw["wedge_after"] = rng.choice((0, 1))
            if self.has_stock and i == 2:
                kw["stock"] = True
            ctx.add_miner(
                f"m{i}",
                delay_fn=lambda size, r=_fork(rng): r.uniform(0.02, 0.2),
                **kw)
        reqs = []
        for _j in range(rng.choice((1, 2))):
            data = f"{rng.choice(_DATA)}#{_j}"
            upper = rng.choice((149, 209))
            if rng.random() < 0.25:
                target = 1          # unreachable: no-hit arg-min path
            else:
                q = rng.randrange(0, upper + 2)
                target = hash_op(data, q) + 1   # q qualifies by def.
            reqs.append(Req(data, 0, upper, target=target,
                            pre_delay=rng.uniform(0.0, 0.3)))
        ctx.add_client("c0", reqs)

    def check(self, ctx: Ctx):
        out = self.check_replies(ctx, weak_ok=self.has_stock)
        out += self.check_global_fifo(ctx)
        out += self.check_accounting(ctx)
        return out


# ------------------------------------------------------------ plane_split

class PlaneSplit(Scenario):
    """The tenant/miner plane split under ONE combined storm:
    a chunked elephant, mice trains, striping, the coalescing window,
    a misbehaving (wedged or slow) miner driving the lease plane, and
    an optional mid-storm client drop — every grant crosses the
    tenant→miner interface, every Result crosses complete, and every
    blown lease crosses lease-event, with the full invariant pack
    (exactly-once oracle-exact per-tenant replies, accounting balance,
    span closure, sanitizer silence) proving the split preserved the
    monolith's semantics."""

    name = "plane_split"

    def build(self, ctx: Ctx) -> None:
        rng = ctx.rng
        _make_sched(ctx, lease=LeaseParams(
            grace_s=1.2, factor=4.0, floor_s=0.8, tick_s=0.1,
            quarantine_after=rng.choice((1, 2)), queue_alarm_s=30.0),
            qos=QosParams(
                enabled=True, chunk_s=0.2, max_chunks=16, depth=2,
                wholesale_s=0.5),
            stripe=StripeParams(enabled=True, chunk_s=0.3, depth=3),
            coalesce=CoalesceParams(enabled=True,
                                    lanes=rng.choice((3, 4)),
                                    small_s=0.25))
        bad = rng.choice((None, 0, 1, 2))
        slow = rng.random() < 0.5
        for i in range(3):
            kw = {}
            mrng = _fork(rng)
            if bad == i and not slow:
                kw["wedge_after"] = rng.choice((0, 1))
            elif bad == i and slow:
                kw["delay_fn"] = \
                    lambda size, r=mrng: r.uniform(1.5, 3.0)
            else:
                kw["delay_fn"] = lambda size, r=mrng: \
                    size / 1000.0 * r.uniform(0.8, 1.2)
            ctx.add_miner(f"m{i}", **kw)
        ctx.spawn(_warm_rates(ctx, 3, 1000.0))
        # Tenant 1: elephant (est ~0.7s > wholesale 0.5 at the warmed
        # 3x1000 nps pool -> chunked activation across the pool slice).
        ctx.add_client("elephant", [
            Req(rng.choice(_DATA), 0, 1999, pre_delay=0.5)])
        # Tenants 2+3: mice trains landing against the elephant's
        # grants (coalescible at the warmed rate).
        for t, n in (("mice_a", 2), ("mice_b", rng.choice((1, 2)))):
            reqs = [Req(f"{rng.choice(_DATA)}#{t}{j}", 0,
                        rng.choice((99, 199)),
                        pre_delay=0.5 + rng.uniform(0.0, 1.2))
                    for j in range(n)]
            ctx.add_client(t, reqs)
        if rng.random() < 0.4:
            # A client that drops right after sending: the cancel path
            # must free both planes without corrupting the others.
            ctx.add_client("dropper", [
                Req(f"{rng.choice(_DATA)}#d", 0, 149,
                    pre_delay=rng.uniform(0.3, 1.0), close_after=True)])

    def check(self, ctx: Ctx):
        out = self.check_replies(ctx)
        out += self.check_accounting(ctx)
        return out


# -------------------------------------------------------- replica_takeover

class ReplicaTakeover(Scenario):
    """Replica sharding: a 2-replica :class:`~...apps.replicas.
    ReplicaSet` over ONE detnet transport, tenants consistent-hashed
    across the replicas and miners sliced between them — then one
    replica is KILLED at a seed-drawn virtual time, possibly
    mid-request. Lease takeover must re-serve the dead replica's queued
    and in-flight requests EXACTLY ONCE, oracle-exact, through the
    survivors (adopted miners' stale answers popping in order), with
    accounting balanced and every live trace closed at quiescence."""

    name = "replica_takeover"

    def build(self, ctx: Ctx) -> None:
        from ...apps.replicas import ReplicaSet
        from ...utils.config import CacheParams as _Cache
        rng = ctx.rng
        rs = ReplicaSet(
            ctx.server, 2,
            lease=LeaseParams(grace_s=5.0, factor=4.0, floor_s=2.0,
                              tick_s=0.1, queue_alarm_s=30.0),
            cache=_Cache(),
            qos=QosParams(enabled=True, chunk_s=0.3, max_chunks=8,
                          depth=2, wholesale_s=0.5),
            stripe=StripeParams(enabled=False),
            coalesce=CoalesceParams(enabled=False),
            verify=_STOCK_VERIFY)
        ctx.sched = rs
        ctx.spawn(rs.run())
        for i in range(3):
            ctx.add_miner(
                f"m{i}",
                delay_fn=lambda size, r=_fork(rng):
                    size / 1000.0 * r.uniform(0.8, 1.2))

        async def warm():
            import asyncio as _a
            while sum(len(s.miners) for s in rs.replicas.values()) < 3:
                await _a.sleep(0.01)
            for sched in rs.replicas.values():
                for m in sched.miners:
                    m.rate_ewma = 1000.0
                sched.miner_plane.pool_rate = 1000.0
        ctx.spawn(warm())

        victim = rng.choice((0, 1))
        kill_at = rng.uniform(0.6, 2.5)

        async def killer():
            import asyncio as _a
            await _a.sleep(kill_at)
            if victim in rs.live and len(rs.live) > 1:
                rs.kill(victim)
        ctx.spawn(killer())

        # Several tenants so BOTH replicas own some: an elephant that
        # may be chunked-in-flight when the kill lands, plus mice.
        ctx.add_client("elephant", [
            Req(rng.choice(_DATA), 0, rng.choice((1499, 1999)),
                pre_delay=0.4)])
        for t, n in (("mice_a", 2), ("mice_b", 2)):
            reqs = [Req(f"{rng.choice(_DATA)}#{t}{j}", 0,
                        rng.choice((99, 199)),
                        pre_delay=0.3 + rng.uniform(0.0, 1.5))
                    for j in range(n)]
            ctx.add_client(t, reqs)

    def check(self, ctx: Ctx):
        out = self.check_replies(ctx)
        out += self.check_accounting(ctx)
        return out


# -------------------------------------------------------- adaptive_control

class AdaptiveControl(Scenario):
    """The self-tuning control plane under the explorer: a
    REAL scheduler with the chunk/window/admission controllers mounted
    on the VIRTUAL clock, a chunked elephant + mice trains, and miners
    whose service rate DRIFTS mid-schedule (a seed-drawn step change —
    the adversarial input a static knob cannot follow). Invariants on
    top of the generic pack: every controller value stays inside its
    hard floor/ceiling at every recorded point, and no post-transient
    oscillation exceeds a bounded peak/trough amplitude
    (:func:`~....apps.adapt.oscillation_ratio`) — an unstable loop
    (self-amplifying sawtooth, limit cycle wider than one
    multiplicative step + dead-band) fails here; starvation fails the
    generic liveness/reply pack."""

    name = "adaptive_control"

    #: Peak/trough bound per post-transient swing: one multiplicative
    #: step (x2 at mul=0.5) compounded with the dead-band and one
    #: ratio-capped probe, doubled for headroom. ONE swing over the
    #: bound is tolerated per history — a congestion episode (anchored
    #: multiplicative descent + the recovery ramp back toward open) is
    #: exactly that shape — but TWO is a limit cycle: a loop swinging
    #: wide repeatedly is fighting its own measurement, which is what
    #: this scenario exists to catch (and did: the pre-settle-tick
    #: chunk controller's EWMA-lag cascade produced wide swings in
    #: BOTH directions).
    AMPLITUDE_BOUND = 5.0

    def build(self, ctx: Ctx) -> None:
        from ...utils.config import AdaptParams
        rng = ctx.rng
        adapt = AdaptParams(
            enabled=True, tick_s=0.2, band=0.25,
            force_s=rng.choice((0.3, 0.5)),
            rate0=rng.choice((0.0, 20.0)))
        _make_sched(ctx, lease=LeaseParams(
            grace_s=5.0, factor=4.0, floor_s=2.0, tick_s=0.1,
            queue_alarm_s=30.0), qos=QosParams(
            enabled=True, chunk_s=0.2, max_chunks=32, depth=2,
            wholesale_s=0.5, max_queued=rng.choice((4, 6))),
            coalesce=CoalesceParams(enabled=True,
                                    lanes=rng.choice((3, 4)),
                                    small_s=0.25),
            adapt=adapt)
        # Miners whose rate steps mid-schedule: the drift the
        # controllers exist to track. The mutable cell is flipped by a
        # timer at a seed-drawn virtual time.
        self.rate_cell = {"rate": 1000.0}
        drift_at = rng.uniform(0.8, 2.0)
        drift_to = rng.choice((400.0, 2500.0))

        async def drift():
            await asyncio.sleep(drift_at)
            self.rate_cell["rate"] = drift_to
        ctx.spawn(drift())
        for i in range(2):
            ctx.add_miner(
                f"m{i}",
                delay_fn=lambda size, r=_fork(rng), cell=self.rate_cell:
                    size / cell["rate"] * r.uniform(0.8, 1.2))
        ctx.spawn(_warm_rates(ctx, 2, 1000.0))
        # Elephant (chunked at the warmed 2x1000 nps pool) + mice
        # trains — the population whose interleavings drive every
        # controller: chunk pops feed the sizing loop, small arrivals
        # the window loop, queue age the admission loop.
        ctx.add_client("elephant", [
            Req(rng.choice(_DATA), 0, 1999, pre_delay=0.5)])
        for t, n in (("mice_a", rng.choice((2, 3))), ("mice_b", 2)):
            reqs = [Req(f"{rng.choice(_DATA)}#{t}{j}", 0,
                        rng.choice((99, 149)),
                        pre_delay=0.5 + rng.uniform(0.0, 1.5))
                    for j in range(n)]
            ctx.add_client(t, reqs)

    def check(self, ctx: Ctx):
        from ...apps.adapt import oscillation_ratios
        out = self.check_replies(ctx)
        out += self.check_accounting(ctx)
        plane = ctx.sched.adapt_plane
        if plane is None:
            return out + ["adaptive_control ran without an adapt plane"]
        for name, (floor, ceil, hist) in plane.histories().items():
            for _t, v in hist:
                if not (floor - 1e-9 <= v <= ceil + 1e-9):
                    out.append(
                        f"adapt {name}: value {v} escaped its clamps "
                        f"[{floor}, {ceil}]")
                    break
            wide = [r for r in oscillation_ratios(hist)
                    if r > self.AMPLITUDE_BOUND]
            if len(wide) >= 2:
                out.append(
                    f"adapt {name}: {len(wide)} swings exceed the "
                    f"{self.AMPLITUDE_BOUND}x amplitude bound (worst "
                    f"{max(wide):.2f}x — limit cycle, not one "
                    f"congestion episode; history tail "
                    f"{[round(v, 4) for _t, v in hist[-8:]]})")
        return out


# ------------------------------------------------------------ wide_miner


class WideMiner(Scenario):
    """A heterogeneous pool: one 100x rate-skewed "mesh" miner
    (joins with the rate-hint JOIN — the scheduler seeds its EWMA from
    the wire, no artificial pin) next to two slow host-tier miners,
    under the REAL scheduler with QoS chunking, striping, and leases
    all live on the virtual clock. A chunked elephant plus mice trains
    drive grants across the skewed pool.

    Invariants on top of the generic pack (exactly-once oracle-exact
    replies, accounting balance, span closure):

    - **No blown-lease storm from rate skew**: every lease is sized
      from the answering miner's OWN rate (hint-seeded for the fast
      miner, measured for the slow ones), so honest miners at 100x
      different speeds must blow ZERO leases however the schedule
      interleaves.
    - **Plans stay inside clamps**: total Requests written to miners
      is bounded by the chunk-plan cap + stripe depth per request — a
      hint- or skew-driven mis-sizing that shatters a request into a
      chunk storm fails here.
    - **Rate-aware placement**: the fast miner ends the storm having
      been granted at least as many nonces as either slow miner —
      share follows the rate EWMAs through the existing DRR/capacity
      planes, with no tier-aware code anywhere.
    """

    name = "wide_miner"

    FAST_RATE = 100_000.0
    SLOW_RATE = 1_000.0

    def build(self, ctx: Ctx) -> None:
        rng = ctx.rng
        sched = _make_sched(ctx, lease=LeaseParams(
            grace_s=5.0, factor=4.0, floor_s=2.0, tick_s=0.1,
            queue_alarm_s=30.0), qos=QosParams(
            enabled=True, chunk_s=0.2, max_chunks=32, depth=2,
            wholesale_s=0.5),
            stripe=StripeParams(enabled=True, chunk_s=0.3, depth=3))
        # m0: the wide miner — 100x the host tier, EWMA seeded from its
        # JOIN rate hint (the wire path under test). m1/m2: host tier.
        self.fast = ctx.add_miner(
            "m0", rate_hint=self.FAST_RATE,
            delay_fn=lambda size, r=_fork(rng):
                size / self.FAST_RATE * r.uniform(0.8, 1.2))
        self.slow = [ctx.add_miner(
            f"m{i}",
            delay_fn=lambda size, r=_fork(rng):
                size / self.SLOW_RATE * r.uniform(0.8, 1.2))
            for i in (1, 2)]

        async def warm():
            # Slow miners warm to their measured tier; the POOL rate is
            # pinned at the slow tier (the hint may have seeded it when
            # the fast miner joined an empty pool) so elephant chunk
            # plans are sized for the majority tier — the fast miner's
            # PER-MINER hint is what the skew-handling must ride.
            while ctx.sched is None or len(ctx.sched.miners) < 3:
                await asyncio.sleep(0.01)
            ctx.sched.miner_plane.pin_rates(self.SLOW_RATE)
        ctx.spawn(warm())
        # Elephant: chunked at the pinned 3x-slow-tier pool estimate
        # (8000 > wholesale_s * rate * n = 1500).
        self.n_requests = 1
        ctx.add_client("elephant", [
            Req(rng.choice(_DATA), 0, rng.choice((7999, 9999)),
                pre_delay=0.5)])
        for t, n in (("mice_a", rng.choice((2, 3))), ("mice_b", 2)):
            reqs = [Req(f"{rng.choice(_DATA)}#{t}{j}", 0,
                        rng.choice((99, 149)),
                        pre_delay=0.5 + rng.uniform(0.0, 1.5))
                    for j in range(n)]
            self.n_requests += n
            ctx.add_client(t, reqs)

    def _granted_nonces(self, ctx: Ctx, conn_id: int) -> int:
        total = 0
        for payload in ctx.server.sent_to(conn_id):
            msg = Message.from_json(payload)
            if msg.type == MsgType.REQUEST:
                total += msg.upper - msg.lower + 1
        return total

    def check(self, ctx: Ctx):
        out = self.check_replies(ctx)
        out += self.check_accounting(ctx)
        stats = ctx.sched.stats
        if stats["leases_blown"]:
            out.append(
                f"rate skew blew {stats['leases_blown']} lease(s) — "
                f"per-miner rate sizing (hint-seeded for the wide "
                f"miner) must keep honest miners inside their leases")
        # Chunk/stripe plans inside clamps: per request at most
        # max_chunks QoS chunks OR stripe.depth chunks per miner share,
        # plus nothing re-issued (leases never blow here).
        n_req = sum(1 for conn in
                    [self.fast.chan.conn_id]
                    + [m.chan.conn_id for m in self.slow]
                    for payload in ctx.server.sent_to(conn)
                    if Message.from_json(payload).type == MsgType.REQUEST)
        bound = self.n_requests * max(32, 3 * 3)
        if n_req > bound:
            out.append(f"chunk storm: {n_req} miner Requests for "
                       f"{self.n_requests} client requests "
                       f"(clamp bound {bound})")
        fast_n = self._granted_nonces(ctx, self.fast.chan.conn_id)
        for m in self.slow:
            slow_n = self._granted_nonces(ctx, m.chan.conn_id)
            if fast_n < slow_n:
                out.append(
                    f"rate-aware placement inverted: 100x miner got "
                    f"{fast_n} nonces, slow miner {m.name} got {slow_n}")
        return out


# --------------------------------------------------------- replayed_storm

#: Parsed captures by path (the explorer re-executes a scenario
#: thousands of times; the capture file is parsed ONCE per process).
_REPLAY_CAPS: dict = {}


def _replay_capture(fixture: str = "replay_fixture.jsonl",
                    env_override: bool = True):
    """The capture a replayed scenario replays: ``DBMT_CHECK_CAPTURE``
    (a gate run may point it at a storm it just captured; honored only
    when ``env_override``), or the checked-in ``fixture`` beside this
    module — ``replay_fixture.jsonl`` is a real mice-stampede run
    captured on the detnet harness, ``replay_transport_fixture.jsonl`` a
    transport-bound ``loadharness --procs`` storm over real UDP sockets
    (the JAX package's captures, copied: the capture format is shared,
    and ``apps.capture.load_capture`` reads either)."""
    path = (str_env("DBMT_CHECK_CAPTURE", "") if env_override
            else "") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), fixture)
    cap = _REPLAY_CAPS.get(path)
    if cap is None:
        from ...apps.capture import load_capture
        cap = _REPLAY_CAPS[path] = load_capture(path)
    return cap


class ReplayedStorm(Scenario):
    """Interleaving exploration over MEASURED traffic: a
    workload capture converts into a scripted population — per-tenant
    arrival pacing and geometry mix from the capture's ``req`` records,
    the miner pool's relative rate skew from its ``pool`` snapshots —
    and the full invariant pack (exactly-once oracle-exact replies,
    accounting balance, span closure, liveness) runs over every
    explored schedule. The seed draws WHICH window of the capture
    replays (tenant subset + offset), jitters the pool, and may wedge
    one miner, so scenario diversity grows from real traffic shapes
    instead of hand-written scripts. Geometry is clamped to
    oracle-checkable sizes (ranges ≤ 512 nonces, vtime-compressed
    arrivals) — the capture drives the SHAPE; the oracle needs the
    scale bounded."""

    name = "replayed_storm"

    #: Clamps keeping one schedule's host-oracle work bounded whatever
    #: capture DBMT_CHECK_CAPTURE points at.
    MAX_TENANTS = 8
    MAX_REQS_PER_TENANT = 3
    MAX_NONCES = 512
    MAX_WINDOW_VTIME = 2.5

    #: Which checked-in capture drives the shape, and whether the
    #: ``DBMT_CHECK_CAPTURE`` override applies (it retargets only the
    #: base scenario).
    FIXTURE = "replay_fixture.jsonl"
    ENV_OVERRIDE = True

    def build(self, ctx: Ctx) -> None:
        from ...apps.capture import replay_plan
        rng = ctx.rng
        cap = _replay_capture(self.FIXTURE, self.ENV_OVERRIDE)
        plan = replay_plan(cap)
        n_ten = rng.randint(4, self.MAX_TENANTS)
        if len(plan) > n_ten:
            at = rng.randrange(0, len(plan) - n_ten + 1)
            window = plan[at:at + n_ten]
        else:
            window = plan
        t_lo = min(p["start"] for p in window)
        dur = max((p["start"] - t_lo)
                  + (p["reqs"][min(len(p["reqs"]),
                                   self.MAX_REQS_PER_TENANT) - 1][0]
                     if p["reqs"] else 0.0)
                  for p in window)
        scale = (min(1.0, self.MAX_WINDOW_VTIME / dur)
                 if dur > 0 else 1.0)
        _make_sched(ctx, lease=LeaseParams(
            grace_s=0.8, factor=4.0, floor_s=0.5, tick_s=0.05,
            quarantine_after=2, queue_alarm_s=30.0),
            qos=QosParams(enabled=True, chunk_s=0.2, max_chunks=16,
                          depth=2, wholesale_s=0.5, max_queued=64))
        # Pool: captured rate EWMAs keep their RELATIVE skew, mapped
        # onto the ~1000-nps virtual-time scale the other scenarios
        # use; one miner may wedge (the capture's reissue events say
        # real traffic saw re-issues too — the shape must survive one
        # here).
        rates = cap.pool_rates() or [1000.0, 1000.0]
        med = sorted(rates)[len(rates) // 2]
        n_m = min(3, max(2, len(rates)))
        wedged = rng.random() < 0.3
        bad = rng.randrange(n_m) if wedged else None
        for i in range(n_m):
            rel = max(0.25, min(4.0, rates[i % len(rates)] / med))
            vrate = 1000.0 * rel
            kw = {}
            mrng = _fork(rng)
            if bad == i:
                kw["wedge_after"] = rng.choice((0, 1))
            else:
                kw["delay_fn"] = (lambda size, r=mrng, v=vrate:
                                  size / v * r.uniform(0.8, 1.2))
            ctx.add_miner(f"m{i}", **kw)
        ctx.spawn(_warm_rates(ctx, n_m, 1000.0))
        for ti, p in enumerate(window):
            reqs = []
            prev = 0.0
            offsets = [p["start"] - t_lo + dt for dt, _n, _m, _d
                       in p["reqs"][:self.MAX_REQS_PER_TENANT]]
            for i, (dt, n, mode, _dc) in enumerate(
                    p["reqs"][:self.MAX_REQS_PER_TENANT]):
                at = offsets[i] * scale
                reqs.append(Req(
                    f"{rng.choice(_DATA)}#{ti}.{i}", 0,
                    min(max(1, n), self.MAX_NONCES) - 1,
                    target=1 if mode == "diff" else 0,
                    pre_delay=max(0.0, at - prev)))
                prev = at
            ctx.add_client(f"t{ti}", reqs)

    def check(self, ctx: Ctx):
        out = self.check_replies(ctx)
        out += self.check_accounting(ctx)
        return out


class ReplayedTransportStorm(ReplayedStorm):
    """The ``replayed_storm`` machinery over a TRANSPORT-BOUND
    capture — a ``loadharness --procs`` storm recorded with
    ``DBMT_CAPTURE=1`` on the real multi-process topology (router +
    replica processes + fake miner agents over real localhost UDP at
    the batched-syscall datapath's admitted/s ceiling), checked in as
    ``replay_transport_fixture.jsonl``. The detnet replay keeps the
    measured arrival pacing and burst shape of traffic that saturated
    the REAL wire, so interleaving exploration covers the burst
    patterns the mmsg datapath actually produces (deep recv bursts,
    ack flushes at pump exit) rather than hand-scripted pacing. The
    fixture is pinned (no ``DBMT_CHECK_CAPTURE`` override): the
    override retargets the base scenario, while this one always
    explores the checked-in transport storm."""

    name = "replayed_transport_storm"
    FIXTURE = "replay_transport_fixture.jsonl"
    ENV_OVERRIDE = False


# -------------------------------------------------------- health_takeover

class _ProcView:
    """Merged invariant view over the model's replica schedulers (the
    harness reads ``ctx.sched._inflight/queue/qos_plane/traces``)."""

    def __init__(self, scheds):
        self._scheds = scheds

    @property
    def _inflight(self):
        out = {}
        for s in self._scheds:
            out.update(s._inflight)
        return out

    @property
    def queue(self):
        return [r for s in self._scheds for r in s.queue]

    @property
    def qos_plane(self):
        from ...apps.replicas import _MergedQos
        return _MergedQos(self._scheds)

    @property
    def traces(self):
        from ...apps.replicas import _MergedTraces
        return _MergedTraces(self._scheds)


class HealthTakeover(Scenario):
    """The multi-process failure model run IN-PROCESS on the
    virtual clock — the same :mod:`...apps.health` detection/fencing
    code the real router executes, against two REAL schedulers on two
    DetServers (one socket per replica, like one socket per process).

    One replica is PARTITIONED at a seed-drawn virtual time: its beat
    seq freezes at the router (missed-beat detection fires — no kill
    hook anywhere) while it KEEPS SERVING its existing conns — the
    gray-failure/fencing case. The router declares it dead, bumps the
    fencing epoch, and re-rings; ring-aware model clients re-resolve on
    conn death/timeout and resubmit to the survivor; the rejoining
    model miner re-attaches like the process miner agent. When the
    partition heals, the victim observes its own fence and simulates
    process exit (every conn of its server drops). Invariants: every
    client gets EXACTLY ONE oracle-exact reply however the schedule
    interleaves detection, late victim Results, and resubmission;
    accounting and spans drain to zero on BOTH replicas."""

    name = "health_takeover"

    def build(self, ctx: Ctx) -> None:
        from ...apps.health import BeatMonitor, RouterState, router_tick
        from ...apps.health import Beat
        from ...lspnet.detnet import DetServer
        from ...utils.config import CacheParams
        rng = ctx.rng
        beat_s = 0.2
        lease = LeaseParams(grace_s=5.0, factor=4.0, floor_s=2.0,
                            tick_s=0.1, queue_alarm_s=30.0)
        qos = QosParams(enabled=True, chunk_s=0.3, max_chunks=8,
                        depth=2, wholesale_s=0.5)
        # One DetServer per replica — one socket per process.
        servers = [ctx.server, DetServer()]
        scheds = []
        for rid in range(2):
            sched = Scheduler(
                servers[rid], lease=lease, cache=CacheParams(),
                stripe=StripeParams(enabled=False), qos=qos,
                coalesce=CoalesceParams(enabled=False),
                verify=_STOCK_VERIFY)
            scheds.append(sched)
            ctx.spawn(sched.run())

            async def sweeps(s=sched):
                while True:
                    await asyncio.sleep(s.lease.tick_s)
                    s.sweep()
            ctx.spawn(sweeps())
        ctx.sched = _ProcView(scheds)
        self.scheds = scheds

        # ---- model health plane on the virtual clock ----
        state = RouterState(BeatMonitor(beat_s, 2))
        membership = state.membership
        self.membership = membership
        bus: dict = {}                  # rid -> latest Beat
        seqs = [0, 0]
        self.victim = victim = rng.choice((0, 1))
        part_at = rng.uniform(0.4, 1.6)
        heal_at = part_at + rng.uniform(1.2, 2.5)
        self.partitioned = False
        self.exited = [False, False]

        def simulate_exit(rid: int) -> None:
            # Process death: every conn of this replica's server drops
            # (clients resubmit elsewhere, the miner rejoins), queued
            # and in-flight state cancels through the normal drop path.
            if self.exited[rid]:
                return
            self.exited[rid] = True
            for conn_id in list(servers[rid]._chans):
                servers[rid].close_conn(conn_id)
                scheds[rid]._on_drop(conn_id)

        async def replica_beats(rid: int) -> None:
            inc = f"r{rid}"
            while True:
                cut = (rid == victim and self.partitioned)
                if not cut:
                    if membership.is_fenced(rid, inc):
                        simulate_exit(rid)
                        return
                    seqs[rid] += 1
                    bus[rid] = Beat(
                        rid=rid, incarnation=inc, seq=seqs[rid],
                        port=rid, serving=True,
                        miners=len(scheds[rid].miners),
                        queue_depth=len(scheds[rid].queue),
                        epoch_seen=membership.epoch)
                await asyncio.sleep(beat_s)

        async def router() -> None:
            while True:
                router_tick(state, list(bus.values()), ctx.loop.time())
                await asyncio.sleep(beat_s / 2)

        async def partition_timer() -> None:
            await asyncio.sleep(part_at)
            self.partitioned = True
            await asyncio.sleep(max(0.05, heal_at - part_at))
            self.partitioned = False

        for rid in range(2):
            ctx.spawn(replica_beats(rid))
        ctx.spawn(router())
        ctx.spawn(partition_timer())

        # ---- rejoining miners (the process miner agent, modeled) ----
        mrngs = [_fork(rng) for _ in range(2)]

        async def miner_agent(idx: int) -> None:
            mrng = mrngs[idx]
            while True:
                live = sorted(membership.live)
                if not live:
                    await asyncio.sleep(0.1)
                    continue
                rid = live[idx % len(live)]
                chan = servers[rid].connect()
                chan.write(new_join().to_json())
                try:
                    while True:
                        payload = await chan.read()
                        msg = Message.from_json(payload)
                        if msg.type != MsgType.REQUEST:
                            continue
                        await asyncio.sleep(
                            (msg.upper - msg.lower + 1) / 1000.0
                            * mrng.uniform(0.8, 1.2))
                        from .scenario import oracle_min
                        h, n = oracle_min(msg.data, msg.lower, msg.upper)
                        chan.write(new_result(h, n).to_json())
                except Exception:   # noqa: BLE001 — conn died: rejoin
                    await asyncio.sleep(0.1)

        for i in range(2):
            ctx.spawn(miner_agent(i))

        async def warm() -> None:
            while any(not s.miners for s in scheds):
                await asyncio.sleep(0.05)
            for s in scheds:
                for m in s.miners:
                    m.rate_ewma = 1000.0
                s.miner_plane.pool_rate = 1000.0
        ctx.spawn(warm())

        # ---- ring-aware clients (the replica-aware retry plane) ----
        from ...apps.replicas import HashRing

        class RingClient:
            def __init__(self, name, requests):
                self.name = name
                self.requests = requests
                self.replies: list = []
                self.shed = False
                self.dropped = False

            @staticmethod
            async def _read_or_none(chan):
                # A coroutine handed to wait_for becomes its own task;
                # it must finish with a VALUE (the drain-phase audit
                # flags any task finishing with an exception, even a
                # consumed one).
                try:
                    return await chan.read()
                except LspError:
                    return None

            async def run(self) -> None:
                for req in self.requests:
                    if req.pre_delay > 0:
                        await asyncio.sleep(req.pre_delay)
                    while True:
                        live = sorted(membership.live)
                        if not live:
                            await asyncio.sleep(0.2)
                            continue
                        rid = HashRing(live).owner(self.name)
                        chan = servers[rid].connect()
                        payload = None
                        try:
                            chan.write(new_request(
                                req.data, req.lower, req.upper,
                                req.target).to_json())
                            payload = await asyncio.wait_for(
                                self._read_or_none(chan), 4.0)
                        except (LspError, asyncio.TimeoutError):
                            payload = None
                        if payload is not None:
                            msg = Message.from_json(payload)
                            if msg.type == MsgType.RESULT:
                                self.replies.append(msg)
                                await chan.close()
                                break
                        # Abandon THIS conn before any resubmission —
                        # the exactly-once contract of the retry plane.
                        await chan.close()
                        await asyncio.sleep(0.2)

        n_mice = rng.choice((2, 3))
        specs = [("elephant", Req(rng.choice(_DATA), 0,
                                  rng.choice((1499, 1999)),
                                  pre_delay=0.4))]
        for j in range(n_mice):
            specs.append((f"mouse{j}",
                          Req(f"{rng.choice(_DATA)}#{j}", 0,
                              rng.choice((99, 199)),
                              pre_delay=0.3 + rng.uniform(0.0, 1.8))))
        for name, req in specs:
            c = RingClient(name, [req])
            ctx.clients.append(c)
            ctx.spawn(c.run(), client=True)

    def check(self, ctx: Ctx):
        out = self.check_replies(ctx)
        out += self.check_accounting(ctx)
        # Detection really fired off missed beats in schedules where the
        # partition window outlived the monitor window before heal.
        m = self.membership
        if self.exited[self.victim] and self.victim not in m.fenced:
            out.append("victim simulated exit without being fenced")
        return out


# --------------------------------------------------------------- federation

class Federation(Scenario):
    """The two-level scheduler tree run IN-PROCESS on the
    virtual clock — a REAL parent scheduler fronted by two REAL
    :class:`~...apps.gateway.GatewayMiner` actors, each re-sharding its
    grants through a stock inner scheduler on its own DetServer (one
    socket per child cluster, like one socket per process). The parent
    sees nothing but two miners speaking the stock wire: JOINs carry
    pool-summed rate hints over the Rate extension, grants come back as
    merged Results in grant order, and difficulty targets ride through
    both tiers (child miners honor the until extension, so the inner
    merge is strong and the gateway's target echo is truthful).

    Mid-schedule, child cluster 0 FAILS at a seed-drawn virtual time
    (every conn of its inner server dies — miners and bridge alike; the
    inner scheduler itself keeps running, modeling a fenced/empty child
    pool). The gateway reconnects its bridge, resubmits unanswered
    grants in order, finds the pool empty, and the orphan watchdog
    closes its parent conn: ONE drop + blown lease(s) at the parent,
    recovered by the stock re-issue plane granting to the surviving
    gateway. Invariants: every tenant gets EXACTLY ONE oracle-exact
    reply however the schedule interleaves grants, inner re-sharding,
    the failure, and re-issue; accounting and spans drain to zero on
    ALL THREE schedulers."""

    name = "federation"

    def build(self, ctx: Ctx) -> None:
        from ...apps.gateway import GatewayMiner
        from ...lspnet.detnet import DetServer
        from ...utils.config import GatewayParams
        rng = ctx.rng
        lease = LeaseParams(grace_s=4.0, factor=4.0, floor_s=1.5,
                            tick_s=0.1, queue_alarm_s=30.0)
        qos = QosParams(enabled=True, chunk_s=0.3, max_chunks=8,
                        depth=2, wholesale_s=0.5)

        def mk(server) -> Scheduler:
            s = Scheduler(server, lease=lease, cache=CacheParams(),
                          stripe=StripeParams(enabled=False), qos=qos,
                          coalesce=CoalesceParams(enabled=False),
                          verify=_STOCK_VERIFY)
            ctx.spawn(s.run())
            return s

        parent = mk(ctx.server)
        inner_servers = [DetServer(), DetServer()]
        inners = [mk(srv) for srv in inner_servers]
        ctx.sched = _ProcView([parent] + inners)
        self.inners = inners

        # ---- the federation tier: one gateway per child cluster ----
        async def _conn(server):
            return server.connect()

        gw_params = GatewayParams(
            enabled=True, hint_s=rng.uniform(0.3, 0.8), min_pool=1,
            orphan_s=rng.uniform(0.4, 0.9))
        self.gateways = []
        for i in range(2):
            gw = GatewayMiner(
                parent_connect=lambda: _conn(ctx.server),
                bridge_connect=lambda srv=inner_servers[i]: _conn(srv),
                inner_scheds=[inners[i]], params=gw_params,
                poll_s=0.1, backoff_s=0.2, name=f"gw{i}")
            self.gateways.append(gw)
            ctx.spawn(gw.run_forever())

        # ---- child miners: oracle-exact, until-honoring, hinted ----
        pools = [rng.choice((1, 2)), rng.choice((1, 2))]

        async def child(i: int, mrng: random.Random) -> None:
            hint = mrng.uniform(400.0, 4000.0)
            chan = inner_servers[i].connect()
            try:
                chan.write(new_join(rate=int(hint)).to_json())
                while True:
                    payload = await chan.read()
                    msg = Message.from_json(payload)
                    if msg.type != MsgType.REQUEST:
                        continue
                    await asyncio.sleep(
                        (msg.upper - msg.lower + 1) / 1000.0
                        * mrng.uniform(0.8, 1.2))
                    from .scenario import oracle_min, oracle_until
                    if msg.target:
                        h, n, _found = oracle_until(
                            msg.data, msg.lower, msg.upper, msg.target)
                        echo = msg.target
                    else:
                        h, n = oracle_min(msg.data, msg.lower, msg.upper)
                        echo = 0
                    chan.write(new_result(h, n, echo).to_json())
            except LspError:
                return      # child cluster failed under us

        for i in range(2):
            for _j in range(pools[i]):
                ctx.spawn(child(i, _fork(rng)))

        # ---- mid-schedule child-cluster failure (cluster 0) ----
        self.fail_at = rng.uniform(0.6, 2.2)
        self.failed = False

        async def failover() -> None:
            await asyncio.sleep(self.fail_at)
            self.failed = True
            # Whole-cluster death: every conn of the inner server dies
            # (child miners AND the gateway's bridge), and the inner
            # scheduler observes the drops — the simulate_exit shape.
            for conn_id in list(inner_servers[0]._chans):
                inner_servers[0].close_conn(conn_id)
                inners[0]._on_drop(conn_id)
        ctx.spawn(failover())

        # ---- tenants at the parent (oracle-checked) ----
        ctx.add_client("elephant", [Req(rng.choice(_DATA), 0,
                                        rng.choice((1499, 1999)),
                                        pre_delay=0.3)])
        for j in range(rng.choice((2, 3))):
            data = f"{rng.choice(_DATA)}#{j}"
            upper = rng.choice((99, 199))
            target = 0
            if rng.random() < 0.5:
                if rng.random() < 0.25:
                    target = 1      # unreachable: no-hit arg-min path
                else:
                    q = rng.randrange(0, upper + 2)
                    target = hash_op(data, q) + 1
            ctx.add_client(f"mouse{j}",
                           [Req(data, 0, upper, target=target,
                                pre_delay=0.2 + rng.uniform(0.0, 1.5))])

    def check(self, ctx: Ctx):
        out = self.check_replies(ctx)
        out += self.check_accounting(ctx)
        if sum(g.results_forwarded for g in self.gateways) < 1:
            out.append("no Result ever crossed the federation tier "
                       "(gateways never carried the schedule)")
        return out


# ------------------------------------------------------- known-bad fixtures

# --------------------------------------------------------- byzantine_miner

class _ByzantineBase(Scenario):
    """Base of the byzantine_miner family: FakeMiners that
    LIE — fabricated pairs, sentinel-without-scan claims, alternating
    honesty, colluding duplicates — against a REAL scheduler running
    the verification tier (claim checks always; full-window audits with
    a seeded stream where the subclass says so). The generic pack is
    the point: exactly-once ORACLE-EXACT replies prove no lie ever
    reached a client, however the explorer interleaves the liars'
    instant answers against honest scans, claim-retry re-issues, audit
    grants, and trust decay — the acceptance bar is 0 violations while
    any honest miner remains, and every population here keeps at least
    one honest miner.

    Subclasses set ``LIAR_MODES`` (one FakeMiner ``byzantine`` mode per
    liar; the seed draws their positions in the 3-miner pool) and
    ``AUDIT_P`` (1.0 + a full-range ``audit_max_nonces`` where claim
    checks alone cannot see the lie: a sentinel claim is a real pair,
    only re-execution exposes it, and the reply hold + audit repair is
    what keeps the final answer exact)."""

    LIAR_MODES: tuple = ()
    AUDIT_P = 0.0
    #: One optional drop-after-send client (wrong-hash only): a lie
    #: about a cancelled request's chunk pops STALE — never
    #: claim-checked — which the caught-liar soft check must tolerate.
    DROPPER = False

    def build(self, ctx: Ctx) -> None:
        rng = ctx.rng
        _make_sched(
            ctx,
            lease=LeaseParams(grace_s=2.0, factor=4.0, floor_s=0.5,
                              tick_s=0.05, quarantine_after=2,
                              ewma_alpha=0.3, queue_alarm_s=30.0),
            qos=QosParams(enabled=False),
            verify=VerifyParams(enabled=True, audit_p=self.AUDIT_P,
                                audit_max_nonces=1 << 20),
            audit_rng=_fork(rng))
        liar_at = dict(zip(rng.sample(range(3), len(self.LIAR_MODES)),
                           self.LIAR_MODES))
        self.liars = []
        for i in range(3):
            mrng = _fork(rng)
            kw = {"delay_fn": lambda size, r=mrng: r.uniform(0.02, 0.25),
                  "byzantine": liar_at.get(i, "")}
            m = ctx.add_miner(f"m{i}", **kw)
            if kw["byzantine"]:
                self.liars.append(m)
        reqs = []
        for j in range(rng.choice((2, 3))):
            # Unique cache keys (the "#j" suffix): no ResultCache
            # replay, so every reply is a fresh merge the liars raced.
            reqs.append(Req(f"{rng.choice(_DATA)}#{j}", 0,
                            rng.choice((59, 119, 199)),
                            pre_delay=rng.uniform(0.0, 0.3)))
        ctx.add_client("c0", reqs)
        if self.DROPPER and rng.random() < 0.5:
            ctx.add_client("c1", [Req(f"{rng.choice(_DATA)}#x", 0, 99,
                                      pre_delay=rng.uniform(0.0, 0.4),
                                      close_after=True)])

    def check(self, ctx: Ctx):
        out = self.check_replies(ctx)
        out += self.check_accounting(ctx)
        stats = ctx.sched.stats
        lied = sum(m.lies for m in self.liars)
        dropped = any(c.dropped or c.shed for c in ctx.clients)
        if lied and not dropped and not stats["claims_failed"] \
                and not stats["audits_failed"] \
                and not stats["audits_passed"]:
            # Every lie raced a LIVE request (no cancel made it stale),
            # so the tier must have examined at least one: a rejected
            # claim, a failed audit, or a coincidentally-correct
            # sentinel surviving its re-execution. Zero of each means
            # the lies were believed unexamined.
            out.append(
                f"{lied} lie(s) answered live requests but the "
                f"verification tier recorded nothing (claims_failed=0, "
                f"no audit outcomes)")
        if self.AUDIT_P >= 1.0 and not dropped \
                and not stats["audits_issued"]:
            out.append("audit_p=1.0 yet no audit was ever issued")
        return out


class ByzantineWrongHash(_ByzantineBase):
    """One or two miners fabricate an unbeatable fake pair (wrong-hash
    class): the claim check's SHA-256 recompute must reject every one
    BEFORE merge and re-issue the range until an honest scan answers.
    No audits — this class dies at the claim layer."""

    name = "byzantine_wrong_hash"
    DROPPER = True

    def build(self, ctx: Ctx) -> None:
        self.LIAR_MODES = ("wrong_hash",) * ctx.rng.choice((1, 2))
        super().build(ctx)


class ByzantineCollude(_ByzantineBase):
    """Colluding duplicates: TWO miners submit the IDENTICAL fabricated
    pair (FakeMiner wrong-hash fabrication is deterministic), the class
    that defeats any vote-counting verifier. Recomputation does not
    count votes: both copies must fail the claim check independently,
    and the surviving honest miner's scans answer everything."""

    name = "byzantine_collude"
    LIAR_MODES = ("wrong_hash", "wrong_hash")


class ByzantineSentinel(_ByzantineBase):
    """Sentinel-without-scan: the liar hashes ONE nonce and claims it
    as its chunk's argmin — a REAL in-range pair the claim check
    cannot fault. Full-window audits (p=1.0) re-execute every merged
    chunk on a disjoint miner while the reply HOLDS; a failed audit
    merges the auditor's verified sub-argmin (the repair) before the
    release, so the client still sees the oracle-exact answer."""

    name = "byzantine_sentinel"
    LIAR_MODES = ("sentinel",)
    AUDIT_P = 1.0


class ByzantineSelective(_ByzantineBase):
    """Selectively-correct: the liar alternates honest scans with
    sentinel claims — building trust and spending it, the adversary
    reputation decay alone cannot keep out. Full-window audits catch
    each lying call regardless of the honest calls around it."""

    name = "byzantine_selective"
    LIAR_MODES = ("selective",)
    AUDIT_P = 1.0


class FixtureLostUpdate(Scenario):
    """KNOWN-BAD: classic read-yield-write lost update. Two tasks
    increment a counter with an await between load and store; any
    schedule that interleaves the loads loses one increment. dbmcheck
    MUST find a failing schedule here (tests pin that it does)."""

    name = "fixture_lost_update"

    def build(self, ctx: Ctx) -> None:
        self.box = {"counter": 0}

        async def bump():
            v = self.box["counter"]
            await asyncio.sleep(0)       # the racy yield point
            self.box["counter"] = v + 1

        ctx.spawn(bump(), client=True)
        ctx.spawn(bump(), client=True)

    def check(self, ctx: Ctx):
        if self.box["counter"] != 2:
            return [f"lost update: counter is {self.box['counter']}, "
                    f"expected 2"]
        return []


class FixtureDoubleReply(Scenario):
    """KNOWN-BAD: a mini-scheduler that replies on a merged chunk
    WITHOUT the answered[] guard the real scheduler carries — two
    racing Results (a speculative re-issue and its original) can both
    pass the not-yet-answered check and double-reply."""

    name = "fixture_double_reply"

    def build(self, ctx: Ctx) -> None:
        self.replies: list = []
        self.answered = False

        async def on_result(tag):
            if not self.answered:
                await asyncio.sleep(0)   # check-then-act without a latch
                self.replies.append(tag)
                self.answered = True

        ctx.spawn(on_result("original"), client=True)
        ctx.spawn(on_result("reissue"), client=True)

    def check(self, ctx: Ctx):
        if len(self.replies) != 1:
            return [f"exactly-once broken: {len(self.replies)} replies "
                    f"({self.replies})"]
        return []


SCENARIOS = {
    "lease_reissue": LeaseReissue,
    "qos_shed": QosShed,
    "pipelined_dispatch": PipelinedDispatch,
    "batched_dispatch": BatchedDispatch,
    "difficulty_prefix": DifficultyPrefix,
    "plane_split": PlaneSplit,
    "wide_miner": WideMiner,
    "replayed_storm": ReplayedStorm,
    "replayed_transport_storm": ReplayedTransportStorm,
    "replica_takeover": ReplicaTakeover,
    "adaptive_control": AdaptiveControl,
    "health_takeover": HealthTakeover,
    "federation": Federation,
    "byzantine_wrong_hash": ByzantineWrongHash,
    "byzantine_collude": ByzantineCollude,
    "byzantine_sentinel": ByzantineSentinel,
    "byzantine_selective": ByzantineSelective,
}

FIXTURES = {
    "fixture_lost_update": FixtureLostUpdate,
    "fixture_double_reply": FixtureDoubleReply,
}

ALL = {**SCENARIOS, **FIXTURES}
