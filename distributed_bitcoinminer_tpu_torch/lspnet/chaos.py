"""Seeded chaos: miners that fail on a schedule, and process storms.

Counterpart of the JAX package's ``lspnet/chaos.py``. Real outages are
rarely the symmetric packet knobs of ``faults``: a miner process dies and
comes back, a card wedges while its transport keeps heartbeating, one
direction of one flow blackholes, a miner turns coat. This module has
those primitives and a seeded schedule runner over all of them:

- :class:`WedgeableSearcher` hangs the compute until its gate is set,
  modelling a card stuck inside a kernel behind a healthy LSP connection
  (the failure the scheduler's chunk leases exist for);
- :class:`ByzantineSearcher` makes the answers lie (:data:`BYZANTINE_MODES`),
  the failure the verification tier's claim checks and audits exist for;
- :class:`ChaosMiner`, a restartable miner with crash-kill, wedge and lie
  controls; its searchers default to the miner's
  ``default_searcher_factory`` on ``cuda`` (the JAX ``ChaosMiner``
  defaults to its host searcher; the port's entry points run on the card
  unless asked), and tests pass a CPU factory;
- :func:`generate_schedule`, a seeded list of self-healing episodes
  (every kill gets a restart, every wedge an unwedge, every partition a
  heal, every knob a clear), and :func:`run_schedule`, which applies one
  on the event loop's clock and restores a clean network and pool in its
  ``finally``;
- the process storm: :func:`generate_proc_storm` and
  :func:`run_proc_episode` (a replica's SIGKILL or SIGSTOP, or the
  router's SIGKILL, against a live ``apps.procs.ProcCluster``). The
  episode's reply is held to an ``oracle`` argument, by default
  ``bitcoin.hash.scan_min`` (the JAX episode calls its hashlib
  ``scan_min`` itself, which cannot scan a request sized for the card).

The wrappers wrap ``search`` and ``search_until`` only, so a miner serves
them through its blocking path, one chunk at a time, on a worker thread
while its event loop keeps the connection alive.

Determinism: a schedule's content is a function of its seed. The packet
coin flips (``faults.sometimes``) ride Python's global ``random``, which
:func:`seed_packet_faults` pins. The events' timing rides the event
loop's clock, so interleavings differ between runs; what the storms
check (each answer exact and delivered once, the pool converging) holds
for every interleaving.
"""

from __future__ import annotations

import asyncio
import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from ..bitcoin.hash import hash_op
from ..lsp.errors import LspError
from . import faults

logger = logging.getLogger("dbmt.lspnet.chaos")


def seed_packet_faults(seed: int) -> None:
    """Pin the global RNG behind the ``faults.sometimes`` coin flips."""
    random.seed(seed)


class WedgeableSearcher:
    """Wrap a searcher so its compute can be hung and released at will:
    while ``gate`` is clear, ``search``/``search_until`` block."""

    def __init__(self, inner, gate: Optional[threading.Event] = None):
        self._inner = inner
        if gate is None:
            gate = threading.Event()
            gate.set()
        self.gate = gate
        # Claim the until extension only when the inner searcher speaks
        # it: the miner echoes a Request's target iff the attribute is
        # there, and the scheduler grades its merge by that echo.
        if not hasattr(inner, "search_until"):
            self.search_until = None

    def search(self, lower: int, upper: int):
        self.gate.wait()
        return self._inner.search(lower, upper)

    def search_until(self, lower: int, upper: int, target: int):
        self.gate.wait()
        return self._inner.search_until(lower, upper, target)


#: The lies. ``wrong_hash`` claims hash 0 at the range's first nonce,
#: which the claim check rejects; ``sentinel`` claims the true hash of the
#: range's first nonce without scanning, which only an audit can catch;
#: ``selective`` alternates honest and sentinel answers.
BYZANTINE_MODES = ("wrong_hash", "sentinel", "selective")


class ByzantineSearcher:
    """Wrap a searcher so its answers lie per ``mode`` while ``lie_flag``
    is set, and pass through to the inner searcher while it is clear."""

    def __init__(self, inner, data: str, mode: str,
                 lie_flag: threading.Event):
        if mode not in BYZANTINE_MODES:
            raise ValueError(f"unknown mode {mode!r}")
        self._inner = inner
        self._data = data
        self._mode = mode
        self._lie_flag = lie_flag
        self._calls = 0
        if not hasattr(inner, "search_until"):
            self.search_until = None

    def _fabricate(self, lower: int):
        """This call's lie, or None to answer honestly."""
        if not self._lie_flag.is_set():
            return None
        self._calls += 1
        if self._mode == "selective" and self._calls % 2:
            return None
        if self._mode == "wrong_hash":
            return (0, lower)
        return (hash_op(self._data, lower), lower)

    def search(self, lower: int, upper: int):
        out = self._fabricate(lower)
        return out if out is not None else self._inner.search(lower, upper)

    def search_until(self, lower: int, upper: int, target: int):
        out = self._fabricate(lower)
        if out is not None:
            h, nonce = out
            return (h, nonce, h < target)
        return self._inner.search_until(lower, upper, target)


class ChaosMiner:
    """A restartable miner with crash-kill, compute-wedge and lying
    controls.

    One handle is one miner "host" across restarts: each :meth:`start`
    joins the pool as a new LSP connection, and the wedge gate and the
    lie flag are shared across restarts (an operator unwedges a host,
    not a process; a compromised host stays so through a respawn).
    ``searcher_factory(data)`` builds the inner searcher, by default the
    miner's ``default_searcher_factory(data, "cuda")``."""

    def __init__(self, hostport: str, params=None,
                 searcher_factory: Optional[Callable] = None,
                 name: str = "miner", byzantine: str = ""):
        from ..apps.miner import MinerWorker, default_searcher_factory
        self._worker_cls = MinerWorker
        self.hostport = hostport
        self.params = params
        self.name = name
        self.gate = threading.Event()
        self.gate.set()
        #: Set while lying (it matters only with a ``byzantine`` mode; the
        #: miner starts honest and a schedule's "byzantine" event sets it).
        self.lie_flag = threading.Event()
        self.byzantine = byzantine
        inner = searcher_factory
        if inner is None:
            inner = lambda data: default_searcher_factory(  # noqa: E731
                data, "cuda")
        if byzantine:
            base = inner
            inner = lambda data: ByzantineSearcher(  # noqa: E731
                base(data), data, byzantine, self.lie_flag)
        self._factory = lambda data: WedgeableSearcher(inner(data),
                                                       self.gate)
        self.worker = None
        self.task: Optional[asyncio.Task] = None
        self.restarts = 0

    async def start(self) -> None:
        if self.alive:
            raise RuntimeError(f"{self.name} already running")
        self.worker = self._worker_cls(self.hostport, params=self.params,
                                       searcher_factory=self._factory)
        await self.worker.join()
        self.task = asyncio.get_running_loop().create_task(self.worker.run())

    @property
    def alive(self) -> bool:
        return self.task is not None and not self.task.done()

    @property
    def conn_id(self) -> int:
        """The server-side conn id of the current incarnation (0 when
        dead)."""
        if self.worker is None or self.worker.client is None:
            return 0
        return self.worker.client.conn_id()

    def wedge(self) -> None:
        """Hang the next compute (the connection stays alive)."""
        logger.info("chaos: wedging %s", self.name)
        self.gate.clear()

    def unwedge(self) -> None:
        logger.info("chaos: unwedging %s", self.name)
        self.gate.set()

    @property
    def wedged(self) -> bool:
        return not self.gate.is_set()

    def go_byzantine(self) -> None:
        """Start lying in the ``byzantine`` mode (without one the flag is
        set but nothing reads it)."""
        logger.info("chaos: %s turns byzantine (%s)", self.name,
                    self.byzantine or "no mode: inert")
        self.lie_flag.set()

    def go_honest(self) -> None:
        if self.lie_flag.is_set():
            logger.info("chaos: %s turns honest", self.name)
        self.lie_flag.clear()

    @property
    def lying(self) -> bool:
        return self.lie_flag.is_set()

    async def kill(self) -> None:
        """Crash, not close: abort the conn and drop the socket, so the
        scheduler learns of the death only from its epoch timer."""
        if self.worker is None:
            return
        logger.info("chaos: killing %s (conn %d)", self.name, self.conn_id)
        client = self.worker.client
        if client is not None:
            if client._conn is not None:
                client._conn.abort()
            if client._ep is not None:
                client._ep.close()
        if self.task is not None:
            # A wedged compute thread never ends its read loop: give the
            # task a moment, then cancel it (the thread is released by
            # the unwedge of run_schedule's and the tests' cleanup).
            try:
                await asyncio.wait_for(asyncio.shield(self.task), 1.0)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                self.task.cancel()
                try:
                    await self.task
                except asyncio.CancelledError:
                    pass
            self.task = None
        self.worker = None

    async def restart(self) -> None:
        self.restarts += 1
        logger.info("chaos: restarting %s", self.name)
        # Always kill first: a worker whose run() returned (its transport
        # died) still holds an open endpoint and receive task.
        await self.kill()
        await self.start()

    async def close(self) -> None:
        """Release any wedged thread, then kill."""
        self.unwedge()
        await self.kill()


# ---------------------------------------------------------------- schedule

@dataclass(frozen=True)
class ChaosEvent:
    at: float          # seconds from the schedule's start
    action: str        # see _apply_event
    subject: str = ""  # the miner's name, for the miner actions
    value: int = 0     # the percentage, for the knob actions


#: The episode kinds :func:`generate_schedule` draws from; each expands
#: to a fault and its healing event.
EPISODES = ("drop_read", "drop_write", "delay", "kill", "wedge",
            "partition_in", "partition_out")

#: :data:`EPISODES` plus the turn-coat episode. Kept out of the default
#: so the default schedules stay those of the JAX package; storms whose
#: :class:`ChaosMiner`\ s have a ``byzantine`` mode pass it.
BYZ_EPISODES = EPISODES + ("byzantine",)

#: Each kind heals only itself (its own knob, its own miner's conn):
#: episodes of different kinds overlap, and a global reset would close
#: another episode's fault early. Two overlapping episodes of one knob
#: share it; the first heal closes both.
_HEAL_OF = {"drop_read": "clear_drop_read", "drop_write": "clear_drop_write",
            "delay": "clear_delay", "kill": "restart", "wedge": "unwedge",
            "partition_in": "heal_in", "partition_out": "heal_out",
            "byzantine": "honest"}


def generate_schedule(seed: int, duration_s: float,
                      miner_names: Sequence[str], *,
                      episodes: int = 6, max_percent: int = 30,
                      kinds: Sequence[str] = EPISODES,
                      ) -> List[ChaosEvent]:
    """The self-healing schedule of one seed: each episode opens its
    fault at a seeded time and closes it a seeded interval later, inside
    ``duration_s``; a knob's percentage is drawn from ``[5,
    max_percent]``. The same arguments give the same list (the JAX
    package's, draw for draw)."""
    rng = random.Random(seed)
    events: List[ChaosEvent] = []
    for _ in range(episodes):
        kind = rng.choice(list(kinds))
        start = rng.uniform(0.05, duration_s * 0.6)
        span = rng.uniform(duration_s * 0.15, duration_s * 0.35)
        subject = rng.choice(list(miner_names)) if miner_names else ""
        pct = rng.randint(5, max_percent)
        events.append(ChaosEvent(round(start, 3), kind, subject, pct))
        events.append(ChaosEvent(round(min(start + span, duration_s), 3),
                                 _HEAL_OF[kind], subject, 0))
    return sorted(events, key=lambda e: (e.at, e.action))


async def _apply_event(ev: ChaosEvent,
                       miners: Dict[str, ChaosMiner]) -> None:
    m = miners.get(ev.subject)
    if ev.action == "drop_read":
        faults.set_read_drop_percent(ev.value)
    elif ev.action == "drop_write":
        faults.set_write_drop_percent(ev.value)
    elif ev.action == "delay":
        faults.set_delay_message_percent(ev.value)
    elif ev.action == "clear_drop_read":
        faults.set_read_drop_percent(0)
    elif ev.action == "clear_drop_write":
        faults.set_write_drop_percent(0)
    elif ev.action == "clear_delay":
        faults.set_delay_message_percent(0)
    elif ev.action == "kill":
        if m is not None and m.alive:
            await m.kill()
    elif ev.action == "restart":
        if m is not None and not m.alive:
            try:
                await m.restart()
            except LspError as exc:
                # Its connect can fail under the storm's packet knobs;
                # the miner stays down until run_schedule's final heal.
                logger.info("chaos: restart of %s failed (%r)", m.name, exc)
    elif ev.action == "wedge":
        if m is not None:
            m.wedge()
    elif ev.action == "unwedge":
        if m is not None:
            m.unwedge()
    elif ev.action == "byzantine":
        if m is not None:
            m.go_byzantine()
    elif ev.action == "honest":
        if m is not None:
            m.go_honest()
    elif ev.action == "partition_in":
        if m is not None and m.alive:
            faults.partition_conn(m.conn_id, inbound=True, outbound=False)
    elif ev.action == "partition_out":
        if m is not None and m.alive:
            faults.partition_conn(m.conn_id, inbound=False, outbound=True)
    elif ev.action in ("heal", "heal_in", "heal_out"):
        # This miner's current conn, in this episode's direction only. A
        # partition of an earlier, dead incarnation may linger in the
        # sets; run_schedule's final reset clears it.
        if m is not None:
            faults.heal_conn(m.conn_id,
                             inbound=ev.action != "heal_out",
                             outbound=ev.action != "heal_in")
    else:
        raise ValueError(f"unknown chaos action {ev.action!r}")


async def run_schedule(schedule: Sequence[ChaosEvent],
                       miners: Dict[str, ChaosMiner]) -> int:
    """Apply ``schedule`` on the event loop's clock, then heal everything:
    the ``finally`` restores a fault-free network, releases every wedge
    and lie, and restarts every dead miner, so a caller can check the
    pool's convergence unconditionally. Returns the events applied. A
    restart whose connect fails under the storm's packet faults leaves
    its miner down until that final heal (the JAX runner raises
    there)."""
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    applied = 0
    try:
        for ev in sorted(schedule, key=lambda e: (e.at, e.action)):
            await asyncio.sleep(max(0.0, t0 + ev.at - loop.time()))
            logger.info("chaos: t+%.2fs %s %s %s", loop.time() - t0,
                        ev.action, ev.subject, ev.value or "")
            await _apply_event(ev, miners)
            applied += 1
    finally:
        faults.reset_all_faults()
        for m in miners.values():
            m.unwedge()
            m.go_honest()
        for m in miners.values():
            if not m.alive:
                await m.restart()
    return applied


# ---------------------------------------------------------- process storms

#: The process storm's episode kinds: a SIGKILL of the replica that owns
#: the request in flight, a SIGSTOP of it (alive but silent: its socket
#: stays, its beat freezes, the router fences it), and a SIGKILL of the
#: router (the data path rides the last advertised membership).
PROC_EPISODES = ("kill_replica", "stop_replica", "kill_router")


@dataclass(frozen=True)
class ProcEpisode:
    """One episode: submit a request sized to outlive the failure's
    detection, fault ``fault_at`` seconds later, check the one reply,
    heal."""

    kind: str           # see PROC_EPISODES
    fault_at: float     # seconds after the episode's submit
    max_nonce: int      # the request's size
    tenant: str         # the ring key, also the request's data


def generate_proc_storm(seed: int, episodes: int,
                        kinds: Sequence[str] = PROC_EPISODES,
                        nonce_range=(600_000, 1_200_000),
                        ) -> List[ProcEpisode]:
    """The process storm of one seed (the JAX package's, draw for
    draw)."""
    rng = random.Random(seed)
    out = []
    for i in range(episodes):
        out.append(ProcEpisode(
            kind=rng.choice(list(kinds)),
            fault_at=round(rng.uniform(0.05, 0.3), 3),
            max_nonce=rng.randrange(*nonce_range),
            tenant=f"storm{seed}#{i}"))
    return out


async def run_proc_episode(cluster, ep: ProcEpisode, params,
                           retry=None, reply_timeout_s: float = 60.0,
                           oracle: Optional[Callable] = None) -> dict:
    """Run one :class:`ProcEpisode` against a live
    :class:`~..apps.procs.ProcCluster`, then heal (respawn the killed or
    fenced replica, or the router), so episodes compose into a storm.

    The fault is a raw signal; its detection is the router's missed-beat
    watch alone. The reply must arrive once (through
    ``submit_with_retry``, one conn at a time) and equal
    ``oracle(data, 0, max_nonce + 1)`` (default ``bitcoin.hash.scan_min``;
    a caller with a card passes a direct search). Returns the episode's
    record: kind, victim, reply, the fenced replica's exit code, the
    seconds from the fault to the fence (``fence_s``), to every agent
    serving a survivor (``rejoin_s``) and to the reply (``reply_s``)."""
    from ..apps.client import submit_with_retry
    from ..apps.procs import read_beats, read_membership, resolve_owner
    from ..bitcoin.hash import scan_min
    from ..utils.config import RetryParams
    oracle = oracle or scan_min
    retry = retry or RetryParams(attempts=24, timeout_s=3.0,
                                 backoff_s=0.2, backoff_cap_s=1.0)
    owner = resolve_owner(cluster.statedir, ep.tenant)
    if owner is None:
        raise RuntimeError("no advertised ring before the episode")
    rid = owner[0]
    m0 = read_membership(cluster.statedir)
    t0 = time.monotonic()
    task = asyncio.create_task(submit_with_retry(
        f"ring:{cluster.statedir}", ep.tenant, ep.max_nonce, 0, params,
        retry))
    await asyncio.sleep(ep.fault_at)
    victim = f"replica{rid}" if ep.kind != "kill_router" else "router"
    if ep.kind == "kill_replica":
        cluster.kill_replica(rid)
    elif ep.kind == "stop_replica":
        cluster.stop_replica(rid)
    else:
        cluster.kill_router()
    fault_t = time.monotonic()
    fence = {}

    async def measure_rejoin() -> float:
        """Seconds from the fault until every miner agent of the cluster
        (``cluster.m``) serves a surviving live replica."""
        want = max(1, getattr(cluster, "m", 1))
        while True:
            m = read_membership(cluster.statedir)
            if m is not None and rid not in m.live:
                fence.setdefault("s", time.monotonic() - fault_t)
                live = {r: v["incarnation"] for r, v in m.live.items()}
                joined = sum(
                    b.miners for b in read_beats(cluster.statedir)
                    if b.rid in live and b.serving
                    and b.incarnation == live[b.rid])
                if joined >= want:
                    return time.monotonic() - fault_t
            await asyncio.sleep(0.02)

    rejoin_task = None
    if ep.kind in ("kill_replica", "stop_replica"):
        rejoin_task = asyncio.create_task(measure_rejoin())
    try:
        got = await asyncio.wait_for(task, reply_timeout_s)
    except BaseException:
        # A reply timeout must not orphan the membership poller.
        if rejoin_task is not None:
            rejoin_task.cancel()
        raise
    reply_s = time.monotonic() - fault_t
    rejoin_s = None
    if rejoin_task is not None:
        try:
            rejoin_s = round(await asyncio.wait_for(
                rejoin_task, reply_timeout_s), 3)
        except asyncio.TimeoutError:
            rejoin_task.cancel()
    if got is None:
        raise AssertionError(f"{ep} never answered")
    want = tuple(oracle(ep.tenant, 0, ep.max_nonce + 1))
    if tuple(got[:2]) != want:
        raise AssertionError(f"{ep}: {got} != oracle {want}")
    m1 = read_membership(cluster.statedir)
    # Heal: a fenced SIGSTOP victim is woken first, sees its fence and
    # exits; then the topology is brought back to full strength.
    fenced_exit = None
    if ep.kind == "stop_replica":
        cluster.cont_replica(rid)
        deadline = time.monotonic() + 20.0
        proc = cluster.procs.get(victim)
        while proc is not None and proc.poll() is None \
                and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        fenced_exit = proc.poll() if proc is not None else None
    if ep.kind == "kill_router":
        cluster.respawn_router()
    else:
        cluster.spawn_replica(rid)
    return {"kind": ep.kind, "victim": victim, "reply": list(got),
            "fenced_exit": fenced_exit, "rejoin_s": rejoin_s,
            "fence_s": None if "s" not in fence else round(fence["s"], 3),
            "reply_s": round(reply_s, 3),
            "epoch_before": m0.epoch if m0 is not None else None,
            "epoch_after": m1.epoch if m1 is not None else None,
            "elapsed_s": round(time.monotonic() - t0, 3)}
