"""dbmcheck scenario harness: actors, oracle, invariants.

A SCENARIO is a scripted control-plane population — a real
:class:`~...apps.scheduler.Scheduler` (and, in the pipelined scenario, a
real :class:`~...apps.miner.MinerWorker`) wired over the deterministic
transport shim (:mod:`...lspnet.detnet`) to fake miners and scripted
clients, all running on one :class:`.detloop.DetLoop`. The explorer
re-executes a scenario under different pickers; after every explored
schedule the INVARIANT PACK runs:

- **exactly-once, oracle-exact replies**: every non-shed request gets
  exactly ONE Result, bit-equal to the host oracle (arg-min, or the
  difficulty first-hit/weak contract), in per-tenant submission order —
  the client-visible face of "exactly-once chunk merge under re-issue"
  and of the strict arg-min / first-hit merge rules;
- **FIFO dispatch order** (stock scenarios): Results leave the
  scheduler in global request-arrival order — the reference's
  one-in-flight contract;
- **accounting balance**: after quiescence no request is in flight,
  the queue is empty, and every QoS tenant's granted-but-unanswered
  in-flight count is back to zero (lease/QoS in-flight balance);
- **liveness**: the scenario completes within its virtual-time budget
  (a schedule that wedges the scheduler IS the bug class this harness
  exists to find) and drains to quiescence afterwards;
- **sanitizer silence**: the ``utils.sanitize`` ownership / off-loop
  violation counters must not grow during the schedule (the
  THREAD_SHARED ownership tables, re-checked as happens-before facts
  under the virtual scheduler — the executor hops are real threads);
- **span closure**: every request trace the scheduler
  registered during the schedule is CLOSED (terminal reply/cancel) at
  quiescence — an open span is a forgotten request or a trace-plane
  path that lost its terminal event;
- **no unhandled exceptions** anywhere in the population.

Scenario randomness is layered for shrinkability: BUILD-time constants
(ranges, which miner wedges) come from ``Random(seed)``; RUN-time draws
(per-chunk delays, fake compute costs) come from per-actor child
streams forked at build (see scenarios.py ``_fork``); and the PICKER's
randomness is independent of both. An explicit choice-trace replay
(shrinking, DFS) therefore keeps the population constants fixed and
each actor's k-th timing draw a function of its own k — perturbing one
scheduling choice does not re-roll unrelated actors' timing.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, List, Optional

from ...bitcoin.hash import scan_min, scan_until
from ...bitcoin.message import (Message, MsgType, new_join, new_request,
                                new_result)
from ...lsp.errors import LspError
from ...lspnet.detnet import DetServer
from ...utils.metrics import registry as _registry
from .detloop import DetLoop, Picker, RandomPicker, TracePicker, virtual_time

__all__ = ["Ctx", "Scenario", "FakeMiner", "ClientScript", "Req",
           "execute", "oracle_min", "oracle_until", "SANITIZE_COUNTERS"]

#: Per-schedule budgets. Virtual seconds, not wall seconds: a scenario
#: that cannot finish inside these is reported as a liveness violation.
#: The drain phase gets its OWN step/vtime allowances on top of
#: whatever the main phase consumed — a long-but-legal schedule must
#: not be starved into a spurious "no quiescence" report.
MAX_STEPS = 20_000
MAX_VTIME = 600.0
DRAIN_STEPS = 5_000
DRAIN_VTIME = 120.0

SANITIZE_COUNTERS = ("sanitize.ownership_violations",
                     "sanitize.loop_blocking")

# ------------------------------------------------------------------ oracle

_MIN_CACHE: Dict[tuple, tuple] = {}
_UNTIL_CACHE: Dict[tuple, tuple] = {}


def oracle_min(data: str, lower: int, upper: int) -> tuple:
    """Host-oracle arg-min over the INCLUSIVE range (memoized across
    schedules — the explorer re-runs the same ranges hundreds of
    times)."""
    key = (data, lower, upper)
    hit = _MIN_CACHE.get(key)
    if hit is None:
        hit = _MIN_CACHE[key] = scan_min(data, lower, upper)
    return hit


def oracle_until(data: str, lower: int, upper: int, target: int) -> tuple:
    key = (data, lower, upper, target)
    hit = _UNTIL_CACHE.get(key)
    if hit is None:
        hit = _UNTIL_CACHE[key] = scan_until(data, lower, upper, target)
    return hit


# ------------------------------------------------------------------ actors

class Req:
    """One scripted client request. ``upper`` is the wire-inclusive
    bound; the whole system scans ``[lower, upper+1]`` (the reference
    bound quirk), which is what the oracle checks against."""

    __slots__ = ("data", "lower", "upper", "target", "pre_delay",
                 "close_after")

    def __init__(self, data: str, lower: int, upper: int, target: int = 0,
                 pre_delay: float = 0.0, close_after: bool = False):
        self.data = data
        self.lower = lower
        self.upper = upper
        self.target = target
        self.pre_delay = pre_delay
        self.close_after = close_after   # client drops right after sending


class ClientScript:
    """A scripted tenant: sends its requests in order, then reads
    replies until it has one per request or its conn dies (shed)."""

    def __init__(self, ctx: "Ctx", name: str, requests: List[Req]):
        self.ctx = ctx
        self.name = name
        self.requests = requests
        self.chan = ctx.server.connect()
        self.replies: List[Message] = []
        self.shed = False
        self.dropped = False   # the script itself closed the conn

    async def run(self) -> None:
        import asyncio
        sent = 0
        for req in self.requests:
            if req.pre_delay > 0:
                await asyncio.sleep(req.pre_delay)
            try:
                self.chan.write(new_request(
                    req.data, req.lower, req.upper, req.target).to_json())
            except LspError:
                self.shed = True
                return
            sent += 1
            if req.close_after:
                self.dropped = True
                await self.chan.close()
                return
        while len(self.replies) < sent:
            try:
                payload = await self.chan.read()
            except LspError:
                self.shed = True
                return
            msg = Message.from_json(payload)
            if msg.type == MsgType.RESULT:
                self.replies.append(msg)


class FakeMiner:
    """A well-behaved (or deliberately misbehaving) miner endpoint.

    - ``delay_fn(size) -> float`` virtual seconds of 'compute' for a
      ``size``-nonce chunk;
    - ``wedge_after=N``: answers N chunks then reads forever without
      answering (transport alive, compute wedged — the lease-blow
      shape);
    - ``stock=True``: drops the difficulty target like a reference Go
      miner (answers the chunk arg-min, echoes no target) — the WEAK
      merge shape;
    - ``rate_hint``: nonces/s sent on the Join's Rate extension (the
      rate-hint path — the scheduler seeds this miner's EWMA
      from it instead of warming through traffic);
    - ``byzantine``: the miner LIES instead of computing.
      ``"wrong_hash"`` fabricates an unbeatable fake pair (hash 1 at
      the range's first nonce — wins every merge unless claim-checked;
      identical across miners, so two such miners are the colluding-
      duplicates class that defeats vote-counting but not
      recomputation); ``"sentinel"`` hashes ONE nonce (the range's
      first) and claims it as the argmin — a real in-range pair only
      re-execution audits can expose; ``"selective"`` alternates
      honest and sentinel answers (builds trust, spends it).
    """

    def __init__(self, ctx: "Ctx", name: str,
                 delay_fn: Optional[Callable[[int], float]] = None,
                 wedge_after: Optional[int] = None, stock: bool = False,
                 rate_hint: float = 0.0, byzantine: str = ""):
        assert byzantine in ("", "wrong_hash", "sentinel", "selective"), \
            byzantine
        self.ctx = ctx
        self.name = name
        self.delay_fn = delay_fn or (lambda size: 0.0)
        self.wedge_after = wedge_after
        self.stock = stock
        self.rate_hint = rate_hint
        self.byzantine = byzantine
        self.chan = ctx.server.connect()
        self.answered = 0
        self.lies = 0

    def _fabricate(self, msg: Message):
        """The byzantine answer for this REQUEST, or None to answer
        honestly (mirrors lspnet.chaos.ByzantineSearcher)."""
        if not self.byzantine:
            return None
        if self.byzantine == "selective" and self.answered % 2 == 0:
            return None          # even calls honest: trust-building
        self.lies += 1
        if self.byzantine == "wrong_hash":
            return (1, msg.lower)
        from ...bitcoin.hash import hash_op
        return (hash_op(msg.data, msg.lower), msg.lower)

    async def run(self) -> None:
        import asyncio
        self.chan.write(new_join(rate=int(self.rate_hint)).to_json())
        while True:
            try:
                payload = await self.chan.read()
            except LspError:
                return
            msg = Message.from_json(payload)
            if msg.type != MsgType.REQUEST:
                continue
            if self.wedge_after is not None \
                    and self.answered >= self.wedge_after:
                continue   # wedged: keep reading, never answer
            lie = self._fabricate(msg)
            if lie is not None:
                # A liar pays NO compute delay — skipping the scan is
                # the whole point of lying, and the instant answer wins
                # more merge races, which is the adversarial pressure
                # the verification tier must hold against.
                self.answered += 1
                try:
                    self.chan.write(new_result(*lie, 0).to_json())
                except LspError:
                    return
                continue
            d = self.delay_fn(msg.upper - msg.lower + 1)
            if d > 0:
                await asyncio.sleep(d)
            # Upper arrives as an exclusive bound but is scanned
            # INCLUSIVE (the reference miner quirk, miner.go:51-52).
            if msg.target and not self.stock:
                h, n, _found = oracle_until(msg.data, msg.lower,
                                            msg.upper, msg.target)
                echo = msg.target
            else:
                h, n = oracle_min(msg.data, msg.lower, msg.upper)
                echo = 0
            self.answered += 1
            try:
                self.chan.write(new_result(h, n, echo).to_json())
            except LspError:
                return


# ----------------------------------------------------------------- context

class Ctx:
    """Everything one schedule execution owns."""

    def __init__(self, loop: DetLoop, rng: random.Random):
        self.loop = loop
        self.rng = rng
        self.server = DetServer()
        self.sched = None                   # set by scenario.build
        self.clients: List[ClientScript] = []
        self.miners: List[FakeMiner] = []
        self._actor_tasks: list = []
        self._client_tasks: list = []

    def spawn(self, coro, client: bool = False):
        task = self.loop.create_task(coro)
        (self._client_tasks if client else self._actor_tasks).append(task)
        return task

    def add_client(self, name: str, requests: List[Req]) -> ClientScript:
        c = ClientScript(self, name, requests)
        self.clients.append(c)
        self.spawn(c.run(), client=True)
        return c

    def add_miner(self, name: str, **kw) -> FakeMiner:
        m = FakeMiner(self, name, **kw)
        self.miners.append(m)
        self.spawn(m.run())
        return m

    def clients_done(self) -> bool:
        return all(t.done() for t in self._client_tasks)

    def quiescent(self) -> bool:
        if self.sched is None:
            return True
        return not self.sched._inflight and not self.sched.queue


# ---------------------------------------------------------------- scenario

class Scenario:
    """One named scripted population + its invariant pack."""

    name = "base"

    def build(self, ctx: Ctx) -> None:
        raise NotImplementedError

    def check(self, ctx: Ctx) -> List[str]:
        """Scenario-specific invariants; the harness adds the generic
        pack (replies/accounting/liveness/sanitizer/exceptions)."""
        return []

    # ------------------------------------------------- reusable checks

    @staticmethod
    def check_replies(ctx: Ctx, weak_ok: bool = False) -> List[str]:
        """Exactly-once, oracle-exact, per-tenant-ordered replies.

        When any two requests in the schedule share a cache key
        ``(data, lower, upper, target)``, a later duplicate may
        legitimately replay from the ResultCache at arrival —
        overtaking queued work by design — so ordering is then
        checked as a MULTISET (each reply oracle-exact for some
        outstanding request) instead of positionally."""
        out = []
        keys = [(r.data, r.lower, r.upper, r.target)
                for c in ctx.clients for r in c.requests]
        has_dups = len(set(keys)) < len(keys)
        for c in ctx.clients:
            expect = list(c.requests)
            if c.shed or c.dropped:
                # A shed/dropped tenant's replies must still be a
                # correct SUBSET (each oracle-exact), at most one each.
                expect = expect if has_dups else expect[:len(c.replies)]
                if len(c.replies) > len(c.requests):
                    out.append(f"{c.name}: {len(c.replies)} replies for "
                               f"{len(c.requests)} requests")
            elif len(c.replies) != len(c.requests):
                out.append(
                    f"{c.name}: {len(c.replies)} replies for "
                    f"{len(c.requests)} requests (exactly-once broken)")
                if not has_dups:
                    expect = expect[:len(c.replies)]
            if not has_dups:
                for i, (req, rep) in enumerate(zip(expect, c.replies)):
                    out.extend(Scenario._check_one(
                        c.name, i, req, rep, weak_ok))
                continue
            # Multiset matching: consume one outstanding request per
            # reply; a reply matching nothing is a violation.
            pending = list(expect)
            for i, rep in enumerate(c.replies):
                matched = None
                for req in pending:
                    if not Scenario._check_one(c.name, i, req, rep,
                                               weak_ok):
                        matched = req
                        break
                if matched is None:
                    out.append(f"{c.name}[{i}]: reply ({rep.hash}, "
                               f"{rep.nonce}) matches no outstanding "
                               f"request")
                else:
                    pending.remove(matched)
        return out

    @staticmethod
    def _check_one(who: str, i: int, req: Req, rep: Message,
                   weak_ok: bool) -> List[str]:
        # The merged scan covers [lower, upper+1] (bound quirk).
        lo, hi = req.lower, req.upper + 1
        if req.target:
            h, n, found = oracle_until(req.data, lo, hi, req.target)
            if found:
                if rep.hash >= req.target:
                    return [f"{who}[{i}]: difficulty answer hash "
                            f"{rep.hash} does not qualify (target "
                            f"{req.target})"]
                from ...bitcoin.hash import hash_op
                if hash_op(req.data, rep.nonce) != rep.hash:
                    return [f"{who}[{i}]: difficulty answer "
                            f"(h={rep.hash}, n={rep.nonce}) is not a "
                            f"real (hash, nonce) pair"]
                if not weak_ok and (rep.hash, rep.nonce) != (h, n):
                    return [f"{who}[{i}]: difficulty answer "
                            f"(h={rep.hash}, n={rep.nonce}) is not the "
                            f"globally first hit ({h}, {n})"]
                return []
            # No hit in range: exact arg-min, like stock.
            if (rep.hash, rep.nonce) != (h, n):
                return [f"{who}[{i}]: no-hit difficulty answer "
                        f"({rep.hash}, {rep.nonce}) != arg-min "
                        f"({h}, {n})"]
            return []
        h, n = oracle_min(req.data, lo, hi)
        if (rep.hash, rep.nonce) != (h, n):
            return [f"{who}[{i}]: answer ({rep.hash}, {rep.nonce}) != "
                    f"oracle arg-min ({h}, {n}) over [{lo}, {hi}]"]
        return []

    @staticmethod
    def check_global_fifo(ctx: Ctx) -> List[str]:
        """Stock path only: Results leave in request-arrival order.

        Arrival order is the DetServer read-queue delivery order of
        REQUEST payloads; reply order is the write order of RESULTs to
        client conns. Under the reference one-in-flight FIFO contract
        the two sequences' conn ids must match position-wise.

        Results may legitimately be MISSING for a conn whose client
        dropped or was shed (its request cancels); what may never happen
        is a reply overtaking an earlier-arrived live request — so the
        reply sequence must be an order-preserving subsequence of the
        arrival sequence whose skipped entries all belong to
        dropped/shed conns."""
        client_ids = {c.chan.conn_id for c in ctx.clients}
        gone = {c.chan.conn_id for c in ctx.clients
                if c.dropped or c.shed}
        arrivals = []
        for c, payload in ctx.server._read_log:
            if c not in client_ids:
                continue
            msg = Message.from_json(payload)
            if msg.type == MsgType.REQUEST:
                arrivals.append(c)
        replies = [c for c, payload in ctx.server.writes
                   if c in client_ids
                   and Message.from_json(payload).type == MsgType.RESULT]
        i = 0
        for conn in arrivals:
            if i < len(replies) and replies[i] == conn:
                i += 1
            elif conn not in gone:
                return [f"FIFO order broken: request arrivals (conns) "
                        f"{arrivals}, replies {replies} — conn {conn} "
                        f"skipped or overtaken"]
        if i < len(replies):
            return [f"FIFO: more replies than arrivals "
                    f"({replies} vs {arrivals})"]
        return []

    @staticmethod
    def check_accounting(ctx: Ctx) -> List[str]:
        """Post-quiescence lease/QoS in-flight balance."""
        out = []
        sched = ctx.sched
        if sched is None:
            return out
        if sched._inflight:
            out.append(f"requests still in flight after drain: "
                       f"{sorted(sched._inflight)}")
        if sched.queue:
            out.append(f"{len(sched.queue)} request(s) still queued "
                       f"after drain")
        for tenant, st in sched.qos_plane.tenants.items():
            if st.inflight != 0:
                out.append(
                    f"tenant {tenant}: {st.inflight} granted chunks "
                    f"still accounted in flight after quiescence "
                    f"(accounting imbalance)")
        return out

    @staticmethod
    def check_spans_closed(ctx: Ctx) -> List[str]:
        """Trace-span completeness at quiescence: every
        request trace the scheduler REGISTERED (dispatched, shed, or
        cache-replayed — queued-then-purged requests never register)
        must be CLOSED (terminal ``reply``/``cancel`` event) once
        nothing is in flight and nothing is queued. An open trace at
        quiescence is a request the scheduler forgot to answer OR a
        trace-plane path that dropped its terminal event — both real
        bugs the per-schedule exploration should surface, not just the
        e2e suites."""
        out = []
        sched = ctx.sched
        if sched is None or sched._inflight or sched.queue:
            return out     # not quiescent: accounting checks report that
        for key, trace in sched.traces.items():
            if not trace.closed:
                events = [e["event"] for e in trace.to_dict()["events"]]
                out.append(
                    f"trace {key!r} open at quiescence (span leak): "
                    f"events={events}")
        return out


# ---------------------------------------------------------------- executor

class ScheduleResult:
    __slots__ = ("scenario", "seed", "status", "steps", "violations",
                 "trace", "choices", "explicit")

    def __init__(self, scenario, seed, status, steps, violations, trace,
                 explicit=False):
        self.scenario = scenario
        self.seed = seed
        self.status = status
        self.steps = steps
        self.violations = violations
        self.trace = trace                   # [(n_alternatives, chosen)]
        self.choices = [c for _n, c in trace]
        self.explicit = explicit             # ran from an explicit trace

    @property
    def failed(self) -> bool:
        return bool(self.violations)

    def schedule_key(self) -> int:
        return hash(tuple(self.steps))


def execute(scenario: Scenario, seed: int,
            choices: Optional[List[int]] = None,
            quiet: bool = True) -> ScheduleResult:
    """Run one schedule of ``scenario``: random walk from ``seed``, or
    an explicit choice-trace replay (``choices``) with the same
    scenario-level randomness. ``quiet`` mutes the ``dbmt.*`` loggers
    for the run — scenarios deliberately blow leases and shed tenants,
    and a thousand-schedule exploration must not pay (or emit) a
    warning line per event; pass False when debugging one schedule."""
    import logging
    dbm_logger = logging.getLogger("dbmt")
    prev_level = dbm_logger.level
    if quiet:
        dbm_logger.setLevel(logging.CRITICAL)
    try:
        return _execute(scenario, seed, choices)
    finally:
        dbm_logger.setLevel(prev_level)


def _execute(scenario: Scenario, seed: int,
             choices: Optional[List[int]]) -> ScheduleResult:
    if choices is not None:
        picker: Picker = TracePicker(choices)
    else:
        picker = RandomPicker(random.Random((seed << 1) ^ 0x9E3779B9))
    loop = DetLoop(picker)
    rng = random.Random(seed)
    ctx = Ctx(loop, rng)
    before = {name: _registry().counter(name).value
              for name in SANITIZE_COUNTERS}
    violations: List[str] = []
    with loop.running(), virtual_time(loop):
        scenario.build(ctx)
        status = loop.run_until(ctx.clients_done, MAX_STEPS, MAX_VTIME)
        if status == "done":
            drain = loop.run_until(ctx.quiescent,
                                   len(loop.steps) + DRAIN_STEPS,
                                   loop.time() + DRAIN_VTIME)
            if drain != "done":
                violations.append(
                    f"no quiescence after completion ({drain}): "
                    f"inflight={sorted(ctx.sched._inflight) if ctx.sched else []} "
                    f"queued={len(ctx.sched.queue) if ctx.sched else 0}")
        else:
            violations.append(
                f"scenario did not complete ({status}) at vtime "
                f"{loop.time():.2f}s after {len(loop.steps)} steps — "
                f"liveness violation")
        loop.drain()
    loop.close()
    violations.extend(scenario.check(ctx))
    # Generic pack addition: every span opened in the
    # explored schedule must be closed at quiescence, whatever the
    # scenario — scenario.check() need not opt in.
    violations.extend(Scenario.check_spans_closed(ctx))
    for name in SANITIZE_COUNTERS:
        delta = _registry().counter(name).value - before[name]
        if delta:
            violations.append(f"{name} grew by {delta} during the "
                              f"schedule (ownership/loop-block)")
    for exc in loop.exceptions:
        violations.append(
            "unhandled exception: "
            f"{exc.get('message')} {exc.get('exception')!r}")
    return ScheduleResult(scenario.name, seed, status, loop.steps,
                          violations, picker.trace,
                          explicit=choices is not None)
