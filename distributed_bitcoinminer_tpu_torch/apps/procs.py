"""The process tier: one OS process per replica, a router, miner agents.

Counterpart of the JAX package's ``apps/procs.py``. The replica tier's
topology as real processes that survive real crashes (``kill -9``,
``SIGSTOP``), failure detected by the health plane (``apps.health``), no
test hook:

- **Replica process** (:class:`ReplicaProcess`, CLI ``replica``): one
  :class:`~.scheduler.Scheduler` on its OWN LSP socket, beating a
  :class:`~.health.Beat` file every ``DBMT_HEALTH_BEAT_S`` seconds and
  watching the published membership for its own fence: a replica that
  finds its ``(rid, incarnation)`` fenced stops serving (closes its
  socket, so clients resubmit and miners rejoin) and exits with
  :data:`FENCED_EXIT` for its supervisor to start afresh.
- **Router process** (:class:`Router`, CLI ``router``): the control
  plane alone. It reads the beat files every beat, runs the shared
  :func:`~.health.router_tick` (a replica whose beat ``seq`` has not
  advanced for ``DBMT_HEALTH_MISS_K`` beats is dead) and publishes
  ``membership.json`` with a bumped fencing epoch. It is not on the data
  path: clients hash their tenant over the published ring themselves
  (``apps.client.submit_with_retry`` with a ``ring:<statedir>`` target),
  so a router restart only delays the next membership change.
- **Miner agent** (:class:`MinerAgent`, CLI ``miner``): a
  :class:`~.miner.MinerWorker` that joins the live replica with the
  thinnest advertised miner slice and, when its conn dies or the
  membership fences its owner, rejoins a survivor.
- **Gateway agent** (:class:`GatewayAgent`, CLI ``gateway``): one process
  holding a whole child cluster (an inner LSP server, a scheduler, N
  in-process child miners and one :class:`~.gateway.GatewayMiner` that
  joins the thinnest live replica as ONE miner), placed and fence-pushed
  as the miner agent is.
- **Replicated cache tier** (:class:`SpoolResultCache`): each replica's
  result cache WRITES THROUGH to an append-only spool file of its
  incarnation, and every replica reads its peers' spools each beat, so a
  tenant hashed to another replica after a failover replays the answers
  the dead one produced. Lines of a FENCED incarnation are dropped at
  ingest; a lost entry costs a recompute, never a wrong or doubled reply.

**Departure, written here:** the JAX agents search with its host tier by
default. The port's agents take the miner's
:func:`~.miner.default_searcher_factory`, so they run on the card
(``cuda``; without one they raise) unless ``DBMT_COMPUTE=host`` asks for
the host tier (:class:`~.miner.HostSearcher`, which raises without
``g++``).

Exactly once across a process's death: a killed replica never replied to
the requests still queued or in flight with it, so the client's retry
plane serves them again through the new ring owner; a retry of an
answered request replays from the replicated cache (or recomputes the
same pure function of the request). The fencing epoch closes the
partitioned-but-alive case: a replica declared dead that keeps serving
answers only conns its clients abandoned, and its cache writes are
refused.

Each agent also publishes its CUDA kernel launches (by the TPU kernel
each replaces, ``K1``..``K6mesh``) as the gauges
``miner.kernel_launches{kernel=...}`` of its rollup blob, so the console
and ``chip_smoke.py`` read each process's launches.

State directory layout (every write atomic)::

    <statedir>/beat_<rid>.json             one Beat per replica
    <statedir>/membership.json             the ring and fencing ledger
    <statedir>/cache_<rid>_<inc>.spool     an append-only result spool
    <statedir>/metrics_<role>_<rid>.json   a rollup snapshot blob

Usage: ``python -m distributed_bitcoinminer_tpu_torch.apps.procs
{router|replica|miner|gateway} <statedir> [options]``
(:func:`main`); :class:`ProcCluster` spawns and signals a whole
topology.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..lsp.errors import LspError
from ..utils._env import float_env, int_env
from .health import Beat, BeatMonitor, Membership, RouterState, router_tick
from .replicas import HashRing
from .rollup import RollupPublisher, gc_stale_blobs, rollup_enabled, stale_k
from .scheduler import ResultCache

logger = logging.getLogger("dbmt.procs")

__all__ = ["ReplicaProcess", "Router", "MinerAgent", "GatewayAgent",
           "SpoolResultCache", "ProcCluster", "beat_path",
           "gc_fenced_spools", "membership_path", "pick_thinnest",
           "read_beats", "read_json", "read_membership", "resolve_owner",
           "write_json_atomic", "FENCED_EXIT"]

#: Exit code of a replica that observed its own fence: its supervisor
#: starts it again with a fresh incarnation, which the router admits.
FENCED_EXIT = 3


def health_beat_s() -> float:
    """``DBMT_HEALTH_BEAT_S`` (default 0.5, at least 0.01): the replicas'
    beat period and the router's poll period."""
    return max(0.01, float_env("DBMT_HEALTH_BEAT_S", 0.5))


def health_miss_k() -> int:
    """``DBMT_HEALTH_MISS_K`` (default 3, at least 1): missed beats
    before a replica is declared dead and fenced."""
    return max(1, int_env("DBMT_HEALTH_MISS_K", 3))


def proc_cache_enabled() -> bool:
    """``DBMT_PROC_CACHE`` (default 1): the spool-replicated cache tier;
    0 keeps each replica's cache to itself (a failover recomputes)."""
    return int_env("DBMT_PROC_CACHE", 1) != 0


def _incarnation() -> str:
    return f"{os.getpid()}-{int(time.time() * 1000)}"


def write_json_atomic(path: str, obj: dict) -> None:
    """Publish ``obj`` at ``path`` atomically (a rename on one
    filesystem)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(obj, fh, sort_keys=True)
    os.replace(tmp, path)


def read_json(path: str) -> Optional[dict]:
    """The document at ``path``, or None when it is missing or torn."""
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def beat_path(statedir: str, rid: int) -> str:
    return os.path.join(statedir, f"beat_{rid}.json")


def membership_path(statedir: str) -> str:
    return os.path.join(statedir, "membership.json")


def read_membership(statedir: str) -> Optional[Membership]:
    """The published membership, or None while none is (the caller backs
    off)."""
    d = read_json(membership_path(statedir))
    return Membership.from_dict(d) if d else None


def read_beats(statedir: str) -> List[Beat]:
    """Every well-formed beat file of the directory."""
    out = []
    try:
        names = os.listdir(statedir)
    except OSError:
        return out
    for name in names:
        if not (name.startswith("beat_") and name.endswith(".json")):
            continue
        d = read_json(os.path.join(statedir, name))
        if d is not None:
            try:
                out.append(Beat.from_dict(d))
            except (TypeError, KeyError):
                continue
    return out


def resolve_owner(statedir: str, key) -> Optional[Tuple[int, str]]:
    """The client-side ring: ``(rid, hostport)`` of the replica owning
    ``key``, or None when no membership or no live replica is published.

    The ring spans the SERVING replicas: live, and advertising at least
    one joined miner in their current incarnation's beat (a replica
    with no miner would queue the request forever while another served).
    While no replica holds a miner, every key resolves to the lowest live
    rid, where the first miner joins."""
    m = read_membership(statedir)
    if m is None or not m.live:
        return None
    counts = {b.rid: b.miners for b in read_beats(statedir)
              if b.rid in m.live
              and b.incarnation == m.live[b.rid]["incarnation"]}
    serving = sorted(r for r in m.live if counts.get(r, 0) > 0)
    rid = HashRing(serving or [min(m.live)]).owner(key)
    return rid, f"127.0.0.1:{m.live[rid]['port']}"


def pick_thinnest(statedir: str) -> Optional[Tuple[int, str, str]]:
    """``(rid, incarnation, hostport)`` of the live replica advertising
    the fewest miners (the lowest rid on a tie), or None while no
    membership is published: where a miner or gateway agent joins."""
    m = read_membership(statedir)
    if m is None or not m.live:
        return None
    counts = {b.rid: b.miners for b in read_beats(statedir)}
    rid = min(sorted(m.live), key=lambda r: counts.get(r, 0))
    entry = m.live[rid]
    return rid, entry["incarnation"], f"127.0.0.1:{entry['port']}"


# ------------------------------------------------------- replicated cache

class SpoolResultCache(ResultCache):
    """A ResultCache that writes through to a spool (the module
    docstring): ``put`` appends one JSON line to this incarnation's spool,
    :meth:`ingest` folds the peers' new lines into the local LRU and drops
    those whose writer incarnation is fenced.

    The LRU is bounded by ``size``; the spool is not, so after
    ``ROTATE_FACTOR * size`` lines (at least 1024) it rotates: the file is
    unlinked and a new ``.<seq>.spool`` begins. Lines a slow peer had not
    read yet are lost with it (a recompute, never a wrong reply). Fenced
    incarnations' spools are removed by the router
    (:func:`gc_fenced_spools`)."""

    ROTATE_FACTOR = 4

    def __init__(self, size: int, statedir: str, rid: int,
                 incarnation: str):
        super().__init__(size)
        self.statedir = statedir
        self.rid = rid
        self.incarnation = incarnation
        self._spool_seq = 0
        self._spool_lines = 0
        self._rotate_at = max(1024, self.ROTATE_FACTOR * size)
        self._spool = os.path.join(
            statedir, f"cache_{rid}_{incarnation}.spool")
        self._offsets: Dict[str, int] = {}     # peer spool -> bytes read
        self.spooled = 0
        self.ingested = 0
        self.dropped_fenced = 0

    def put(self, key, value) -> None:
        super().put(key, value)
        line = json.dumps({"rid": self.rid, "inc": self.incarnation,
                           "key": list(key), "h": value[0],
                           "n": value[1]})
        try:
            with open(self._spool, "a", encoding="utf-8") as fh:
                fh.write(line + "\n")
            self.spooled += 1
            self._spool_lines += 1
            if self._spool_lines >= self._rotate_at:
                self._rotate()
        except OSError:
            logger.warning("cache spool append failed; the entry stays "
                           "local", exc_info=True)

    def _rotate(self) -> None:
        """Unlink the full spool and start the next one; the name keeps
        its ``cache_<rid>_<inc>`` stem (the router's fence GC reads it;
        readers take the writer from the lines)."""
        try:
            os.unlink(self._spool)
        except OSError:
            pass
        self._spool_seq += 1
        self._spool_lines = 0
        self._spool = os.path.join(
            self.statedir,
            f"cache_{self.rid}_{self.incarnation}.{self._spool_seq}.spool")

    def ingest(self, membership: Optional[Membership]) -> int:
        """Fold the peers' new spool lines into the local cache; returns
        the entries taken this call."""
        got = 0
        try:
            names = os.listdir(self.statedir)
        except OSError:
            return 0
        spools = sorted(n for n in names if n.startswith("cache_")
                        and n.endswith(".spool"))
        for gone in set(self._offsets) - set(spools):
            self._offsets.pop(gone, None)
        for name in spools:
            path = os.path.join(self.statedir, name)
            if path == self._spool:
                continue
            offset = self._offsets.get(name, 0)
            try:
                with open(path, "rb") as fh:
                    fh.seek(offset)
                    data = fh.read()
            except FileNotFoundError:
                self._offsets.pop(name, None)
                continue
            except OSError:
                continue
            # Only COMPLETE lines: a read racing the writer's append may
            # end mid-line, which the next pass reads whole.
            end = data.rfind(b"\n")
            if end < 0:
                continue
            self._offsets[name] = offset + end + 1
            for raw in data[:end].splitlines():
                try:
                    d = json.loads(raw.decode("utf-8"))
                    key = tuple(d["key"])
                    value = (int(d["h"]), int(d["n"]))
                    wrid, winc = int(d["rid"]), str(d["inc"])
                except (ValueError, KeyError, TypeError):
                    continue      # a torn line: one recompute
                if membership is not None and \
                        membership.writer_fenced(wrid, winc):
                    self.dropped_fenced += 1
                    continue
                ResultCache.put(self, key, value)   # not spooled again
                got += 1
        self.ingested += got
        return got


def gc_fenced_spools(statedir: str, membership: Membership) -> int:
    """Unlink the spools of FENCED incarnations (their lines are refused
    at ingest; the files are only litter). The router runs it; returns
    the files removed."""
    removed = 0
    try:
        names = os.listdir(statedir)
    except OSError:
        return 0
    for name in names:
        if not (name.startswith("cache_") and name.endswith(".spool")):
            continue
        core = name[len("cache_"):-len(".spool")]
        rid_s, _, rest = core.partition("_")
        inc = rest.split(".")[0]     # without a rotation suffix
        try:
            rid = int(rid_s)
        except ValueError:
            continue
        if membership.writer_fenced(rid, inc):
            try:
                os.unlink(os.path.join(statedir, name))
                removed += 1
            except OSError:
                continue
    return removed


# --------------------------------------------------------- replica process

class ReplicaProcess:
    """One scheduler replica as its own process (the module docstring):
    the LSP server on ``port`` (0: any free one, published in the beat),
    the :class:`~.scheduler.Scheduler` (its settings from the
    environment, ``sched_kw`` overriding them), the beat and the fence
    watch. :meth:`run` returns ``"fenced"`` when the replica saw its own
    fence and stopped serving, ``"closed"`` when its transport closed."""

    def __init__(self, statedir: str, rid: int, port: int = 0,
                 params=None, cache=None, beat_s: Optional[float] = None,
                 spool: Optional[bool] = None, **sched_kw):
        from ..utils.config import cache_from_env
        self.statedir = statedir
        self.rid = rid
        self.port = port
        self.params = params
        self.sched_kw = sched_kw
        self.beat_s = beat_s if beat_s is not None else health_beat_s()
        self.incarnation = _incarnation()
        self.cache_params = cache if cache is not None else cache_from_env()
        use_spool = spool if spool is not None else proc_cache_enabled()
        self.cache: Optional[ResultCache] = None
        if self.cache_params.enabled:
            self.cache = (SpoolResultCache(self.cache_params.size, statedir,
                                           rid, self.incarnation)
                          if use_spool else ResultCache(
                              self.cache_params.size))
        self.server = None
        self.sched = None
        self.fenced = False
        self._seq = 0
        self._rollup = (RollupPublisher(statedir, "replica", rid,
                                        self.incarnation,
                                        beat_s=self.beat_s)
                        if rollup_enabled() else None)

    async def run(self) -> str:
        from ..lsp.server import new_async_server
        from .scheduler import Scheduler
        os.makedirs(self.statedir, exist_ok=True)
        self.server = await new_async_server(self.port, self.params)
        self.sched = Scheduler(self.server, cache=self.cache_params,
                               result_cache=self.cache, **self.sched_kw)
        print(f"Replica {self.rid} listening on port {self.server.port}",
              flush=True)
        self._write_beat()                 # admitted before any request
        if self._rollup is not None:
            self._rollup.publish()
        beat_task = asyncio.get_running_loop().create_task(
            self._beat_loop())
        try:
            await self.sched.run()
            return "fenced" if self.fenced else "closed"
        finally:
            beat_task.cancel()
            self._write_beat(final=True)
            if self._rollup is not None:
                self._rollup.publish(final=True)
            await self.server.close()

    def _write_beat(self, final: bool = False) -> None:
        self._seq += 1
        m = read_membership(self.statedir)
        beat = Beat(
            rid=self.rid, incarnation=self.incarnation, seq=self._seq,
            port=self.server.port if self.server else 0,
            serving=not self.fenced and not final,
            miners=len(self.sched.miners) if self.sched else 0,
            queue_depth=len(self.sched.tenant_plane) if self.sched else 0,
            epoch_seen=m.epoch if m else 0)
        try:
            write_json_atomic(beat_path(self.statedir, self.rid),
                              beat.to_dict())
        except OSError:
            logger.warning("beat write failed; retrying next beat",
                           exc_info=True)

    async def _beat_loop(self) -> None:
        """Each beat: the fence watch, the spool ingest, the beat and the
        rollup blob. On its own fence the replica closes its server, so
        every conn dies and :meth:`run` returns."""
        while True:
            await asyncio.sleep(self.beat_s)
            m = read_membership(self.statedir)
            if m is not None and m.is_fenced(self.rid, self.incarnation):
                self.fenced = True
                logger.warning(
                    "replica %d (%s) observed its own fence at epoch %d: "
                    "closing its socket and exiting", self.rid,
                    self.incarnation, m.epoch)
                self._write_beat()
                await self.server.close()
                return
            if isinstance(self.cache, SpoolResultCache):
                self.cache.ingest(m)
            self._write_beat()
            if self._rollup is not None:
                self._rollup.publish(epoch_seen=m.epoch if m else 0)


# ----------------------------------------------------------------- router

class Router:
    """The membership and health router (the control plane alone)."""

    def __init__(self, statedir: str, beat_s: Optional[float] = None,
                 miss_k: Optional[int] = None):
        self.statedir = statedir
        self.beat_s = beat_s if beat_s is not None else health_beat_s()
        self.miss_k = miss_k if miss_k is not None else health_miss_k()
        self.state = RouterState(BeatMonitor(self.beat_s, self.miss_k))
        self.incarnation = _incarnation()
        self._rollup = (RollupPublisher(statedir, "router", 0,
                                        self.incarnation,
                                        beat_s=self.beat_s)
                        if rollup_enabled() else None)

    def tick(self, now: float, published: bool = True) -> bool:
        """One detection tick over the beat files: publish the membership
        when it changed (or when ``published`` is False); True when it
        changed."""
        changed = router_tick(self.state, read_beats(self.statedir), now)
        if changed or not published:
            write_json_atomic(membership_path(self.statedir),
                              self.state.membership.to_dict())
        if changed:
            m = self.state.membership
            logger.warning("membership epoch %d: live=%s fenced=%s",
                           m.epoch, sorted(m.live),
                           {r: f["epoch"] for r, f in m.fenced.items()})
        return changed

    async def run(self) -> None:
        os.makedirs(self.statedir, exist_ok=True)
        # A restarted router resumes from the published document: the
        # fencing epoch never goes back.
        prior = read_membership(self.statedir)
        if prior is not None:
            self.state.membership = prior
        print(f"Router watching {self.statedir} "
              f"(beat {self.beat_s}s, K={self.miss_k})", flush=True)
        loop = asyncio.get_running_loop()
        published = False
        ticks = 0
        while True:
            changed = self.tick(loop.time(), published)
            published = True
            ticks += 1
            if changed or ticks % 64 == 0:
                # Fenced incarnations' spools are litter; a dead process's
                # blob stays visible (flagged) until it is long stale.
                gc_fenced_spools(self.statedir, self.state.membership)
                gc_stale_blobs(self.statedir, stale_k=stale_k())
            if self._rollup is not None:
                self._rollup.publish(
                    epoch_seen=self.state.membership.epoch)
            await asyncio.sleep(self.beat_s)


# ------------------------------------------------------------ miner agent

def publish_launches() -> None:
    """Set an agent's ``miner.kernel_launches{kernel=...}`` gauges from
    its CUDA kernels' launch counters (``ops.sha256_cuda``)."""
    from ..ops import sha256_cuda
    from ..utils.metrics import registry
    for name, n in sha256_cuda.launches.items():
        # ``launches`` holds one fixed key per kernel of the CUDA
        # library (K1-K6mesh), so the label set is bounded.
        registry().gauge(  # dbmlint: ok[cardinality] fixed kernel names
            "miner.kernel_launches", kernel=name).set(n)


def _default_factory():
    from .miner import default_searcher_factory
    return default_searcher_factory


def agent_worker(hostport: str, params, factory):
    """A :class:`~.miner.MinerWorker` as the miner CLI builds one (the
    coalescing and pipeline knobs from the environment)."""
    from ..utils.config import coalesce_from_env, pipeline_depth_from_env
    from .miner import MinerWorker
    co = coalesce_from_env()
    return MinerWorker(hostport, params=params, searcher_factory=factory,
                       pipeline_depth=pipeline_depth_from_env(),
                       coalesce=co.enabled, coalesce_lanes=co.lanes,
                       coalesce_max=co.max_nonces)


class _Publisher:
    """The rollup presence of a process with no beat file of its own (a
    miner or gateway agent): its blob, keyed by pid, every beat period,
    with its kernel launches."""

    def __init__(self, statedir: str, role: str, incarnation: str):
        self.statedir = statedir
        self.rollup = RollupPublisher(statedir, role, os.getpid(),
                                      incarnation, beat_s=health_beat_s())

    async def loop(self) -> None:
        while True:
            m = await asyncio.to_thread(read_membership, self.statedir)
            publish_launches()
            self.rollup.publish(epoch_seen=m.epoch if m else 0)
            await asyncio.sleep(self.rollup.beat_s)


class MinerAgent:
    """A replica-aware miner: joins the thinnest live slice and rejoins a
    survivor when its conn dies or, sooner, when the membership fences
    its owner.

    Fence-push: a watcher reads the membership every beat and, once the
    owner's rid is gone or wears another incarnation, closes the worker's
    conn, so the rejoin happens about a beat after the router's fence
    rather than after LSP's epoch detection (which stays the backstop
    while no membership can be read: no membership is no evidence).

    ``searcher_factory`` defaults to the miner's
    :func:`~.miner.default_searcher_factory` (the card, or the host tier
    under ``DBMT_COMPUTE=host``; the module docstring's departure).
    """

    def __init__(self, statedir: str, params=None,
                 searcher_factory: Optional[Callable] = None,
                 backoff_s: float = 0.2):
        self.statedir = statedir
        self.params = params
        self.backoff_s = backoff_s
        self.factory = searcher_factory or _default_factory()
        self.joins = 0
        self.fence_pushes = 0
        self._pushed = False
        self.incarnation = _incarnation()
        self._publisher = (_Publisher(statedir, "miner", self.incarnation)
                           if rollup_enabled() else None)

    @staticmethod
    def owner_gone(m: Optional[Membership], rid: int,
                   incarnation: str) -> bool:
        """Has the joined owner left the published ring? True when its rid
        is not live or is live under another incarnation; False without a
        membership."""
        if m is None:
            return False
        entry = m.live.get(rid)
        return entry is None or entry.get("incarnation") != incarnation

    async def _watch_owner(self, rid: int, incarnation: str,
                           worker) -> None:
        period = min(self.backoff_s, health_beat_s())
        while True:
            await asyncio.sleep(period)
            m = await asyncio.to_thread(read_membership, self.statedir)
            if self.owner_gone(m, rid, incarnation):
                self.fence_pushes += 1
                self._pushed = True
                logger.info("miner agent: owner rid %d (%s) fenced; "
                            "closing the conn to rejoin (fence-push #%d)",
                            rid, incarnation, self.fence_pushes)
                await worker.close()
                return

    async def run(self) -> None:
        publisher = None
        if self._publisher is not None:
            publisher = asyncio.get_running_loop().create_task(
                self._publisher.loop())
        try:
            await self._run_inner()
        finally:
            if publisher is not None:
                publisher.cancel()

    async def _run_inner(self) -> None:
        while True:
            picked = pick_thinnest(self.statedir)
            if picked is None:
                await asyncio.sleep(self.backoff_s)
                continue
            rid, incarnation, hostport = picked
            worker = agent_worker(hostport, self.params, self.factory)
            watcher = None
            try:
                await worker.join()
                self.joins += 1
                logger.info("miner agent joined %s (join #%d)", hostport,
                            self.joins)
                watcher = asyncio.get_running_loop().create_task(
                    self._watch_owner(rid, incarnation, worker))
                await worker.run()     # until the conn dies or is pushed
            except LspError as exc:
                logger.info("miner agent join/run to %s failed: %s",
                            hostport, exc)
            finally:
                if watcher is not None:
                    watcher.cancel()
                await worker.close()
            if self._pushed:
                # The membership already names a survivor: no back-off.
                self._pushed = False
                continue
            await asyncio.sleep(self.backoff_s)


class _InstantSearcher:
    """The ``--fake`` agents' compute: an instant answer, a deterministic
    function of (data, lower), for measuring the control plane alone. Its
    hashes are made up, so a cluster of fake miners runs its replicas
    with no verification and no audits."""

    _MIX = 0xBF58476D1CE4E5B9
    _MASK = (1 << 64) - 1

    def __init__(self, data: str):
        self.data = data

    def search(self, lower: int, upper: int):
        h = (hash(self.data) * self._MIX
             + lower * 0x9E3779B97F4A7C15) & self._MASK
        return h, lower


# --------------------------------------------------------- gateway agent

class GatewayAgent:
    """One child cluster in one process: an inner LSP server, a
    :class:`~.scheduler.Scheduler`, ``children`` in-process child
    :class:`~.miner.MinerWorker`\\ s and one
    :class:`~.gateway.GatewayMiner` that joins the replica ring as ONE
    miner. Each (re)join picks the thinnest live slice, and a fence-push
    watcher closes the parent conn the moment the owner leaves the ring.
    ``kill -9`` of the agent shows the parent one dropped miner. Its
    default factory is the miner agent's (the module docstring)."""

    def __init__(self, statedir: str, params=None,
                 searcher_factory: Optional[Callable] = None,
                 children: int = 1, backoff_s: float = 0.2,
                 gateway=None):
        from ..utils.config import gateway_from_env
        self.statedir = statedir
        self.params = params
        self.children = max(1, int(children))
        self.backoff_s = backoff_s
        self.gw_params = gateway if gateway is not None \
            else gateway_from_env()
        self.factory = searcher_factory or _default_factory()
        self.joins = 0
        self.fence_pushes = 0
        self.incarnation = _incarnation()
        self._owner: Optional[Tuple[int, str]] = None
        self.gw = None                      # set by run()
        self._publisher = (_Publisher(statedir, "gateway", self.incarnation)
                           if rollup_enabled() else None)

    async def _parent_connect(self):
        """The GatewayMiner's ``parent_connect``: wait for a published
        live replica, then dial the thinnest slice."""
        from ..lsp.client import new_async_client
        while True:
            picked = await asyncio.to_thread(pick_thinnest, self.statedir)
            if picked is not None:
                rid, incarnation, hostport = picked
                chan = await new_async_client(hostport, self.params)
                self._owner = (rid, incarnation)
                self.joins += 1
                logger.info("gateway agent dialing parent rid %d at %s "
                            "(join #%d)", rid, hostport, self.joins)
                return chan
            await asyncio.sleep(self.backoff_s)

    async def _watch_loop(self) -> None:
        """Fence-push: close the parent conn once the owner left the
        ring; the GatewayMiner then picks a survivor."""
        period = min(self.backoff_s, health_beat_s())
        while True:
            await asyncio.sleep(period)
            owner = self._owner
            chan = self.gw._parent if self.gw is not None else None
            if owner is None or chan is None:
                continue
            m = await asyncio.to_thread(read_membership, self.statedir)
            if MinerAgent.owner_gone(m, owner[0], owner[1]):
                self.fence_pushes += 1
                self._owner = None
                logger.info("gateway agent: owner rid %d (%s) fenced; "
                            "closing the parent conn (fence-push #%d)",
                            owner[0], owner[1], self.fence_pushes)
                try:
                    await chan.close()
                except Exception:  # noqa: BLE001 — already dead
                    pass

    async def _child_loop(self, hostport: str) -> None:
        """One in-process child miner on the inner tier, rejoining after
        its conn ends."""
        while True:
            worker = agent_worker(hostport, self.params, self.factory)
            try:
                await worker.join()
                await worker.run()
            except LspError as exc:
                logger.info("gateway child join/run failed: %s", exc)
            finally:
                await worker.close()
            await asyncio.sleep(self.backoff_s)

    async def run(self) -> None:
        from ..lsp.client import new_async_client
        from ..lsp.params import Params
        from ..lsp.server import new_async_server
        from .gateway import GatewayMiner
        from .scheduler import Scheduler

        lsp = self.params or Params()
        server = await new_async_server(0, lsp)
        sched = Scheduler(server)
        inner = f"127.0.0.1:{server.port}"
        self.gw = GatewayMiner(
            parent_connect=self._parent_connect,
            bridge_connect=lambda: new_async_client(inner, lsp),
            inner_scheds=[sched], params=self.gw_params,
            backoff_s=self.backoff_s, name=f"gateway[{os.getpid()}]")
        coros = [sched.run(), self.gw.run_forever(), self._watch_loop()]
        coros += [self._child_loop(inner) for _ in range(self.children)]
        if self._publisher is not None:
            coros.append(self._publisher.loop())
        tasks = [asyncio.ensure_future(c) for c in coros]
        try:
            await asyncio.gather(*tasks)
        finally:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            await server.close()


# ------------------------------------------------------- process cluster

class ProcCluster:
    """Spawn and signal a whole topology of real processes.

    The cluster only SPAWNS and SIGNALS; failure detection is the
    router's beat watch alone. ``kill_replica`` is a raw SIGKILL;
    ``stop_replica``/``cont_replica`` freeze and thaw one (SIGSTOP stops
    its beat while the OS keeps its socket). Children inherit the
    environment (``DBMT_COMPUTE`` among it: unset, the agents search on
    the card), with the metrics emitter and the queue-age alarms off;
    with ``fake_miners`` the agents answer instantly and the replicas
    run with no audits (``DBMT_AUDIT_P=0``) and no claim verification
    (``--no-verify``: the port has no knob for it). ``logdir`` sends each
    child's output to ``<logdir>/<name>.log`` (else nowhere)."""

    def __init__(self, statedir: str, replicas: int = 2, miners: int = 1,
                 env: Optional[dict] = None, fake_miners: bool = False,
                 gateways: int = 0, children: int = 1,
                 logdir: Optional[str] = None):
        self.statedir = statedir
        self.n = replicas
        self.m = miners
        self.g = gateways
        self.children = children
        self.fake = fake_miners
        self.logdir = logdir
        self.env = dict(os.environ)
        self.env.update({"DBMT_METRICS_INTERVAL_S": "0",
                         "DBMT_QUEUE_ALARM_S": "0"})
        if fake_miners:
            self.env["DBMT_AUDIT_P"] = "0"
        self.env.update(env or {})
        self.procs: Dict[str, object] = {}      # name -> Popen
        self._logs: List[object] = []

    def _spawn(self, name: str, args: List[str]):
        import subprocess
        out = subprocess.DEVNULL
        if self.logdir is not None:
            os.makedirs(self.logdir, exist_ok=True)
            out = open(os.path.join(self.logdir, f"{name}.log"), "ab")
            self._logs.append(out)
        proc = subprocess.Popen(
            [sys.executable, "-m", f"{__package__}.procs", *args],
            env=self.env, cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
            stdout=out, stderr=subprocess.STDOUT)
        self.procs[name] = proc
        return proc

    def start(self) -> None:
        os.makedirs(self.statedir, exist_ok=True)
        self._spawn("router", ["router", self.statedir])
        for rid in range(self.n):
            self.spawn_replica(rid)
        for i in range(self.m):
            self.spawn_miner(i)
        for i in range(self.g):
            self.spawn_gateway(i)

    def spawn_miner(self, i: int):
        fake = ["--fake"] if self.fake else []
        return self._spawn(f"miner{i}", ["miner", self.statedir, *fake])

    def spawn_gateway(self, i: int):
        fake = ["--fake"] if self.fake else []
        return self._spawn(f"gateway{i}", [
            "gateway", self.statedir, "--children", str(self.children),
            *fake])

    def spawn_replica(self, rid: int):
        args = ["replica", self.statedir, "--rid", str(rid)]
        if self.fake:
            args.append("--no-verify")
        return self._spawn(f"replica{rid}", args)

    def respawn_router(self):
        return self._spawn("router", ["router", self.statedir])

    def _signal(self, name: str, sig: int) -> bool:
        proc = self.procs.get(name)
        if proc is None or proc.poll() is not None:
            return False
        os.kill(proc.pid, sig)
        return True

    def kill_replica(self, rid: int) -> bool:
        import signal
        return self._signal(f"replica{rid}", signal.SIGKILL)

    def stop_replica(self, rid: int) -> bool:
        import signal
        return self._signal(f"replica{rid}", signal.SIGSTOP)

    def cont_replica(self, rid: int) -> bool:
        import signal
        return self._signal(f"replica{rid}", signal.SIGCONT)

    def kill_router(self) -> bool:
        import signal
        return self._signal("router", signal.SIGKILL)

    def replica_alive(self, rid: int) -> bool:
        proc = self.procs.get(f"replica{rid}")
        return proc is not None and proc.poll() is None

    def membership(self) -> Optional[Membership]:
        return read_membership(self.statedir)

    async def wait_live(self, k: int, timeout_s: float = 20.0,
                        miners: int = 0) -> Membership:
        """Wait until the published membership has ``k`` live replicas
        and their beats show at least ``miners`` joined miners; raises
        TimeoutError after ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            m = self.membership()
            if m is not None and len(m.live) == k and miners <= sum(
                    b.miners for b in read_beats(self.statedir)
                    if b.rid in m.live and b.serving):
                return m
            await asyncio.sleep(0.05)
        m = self.membership()
        raise TimeoutError(f"membership never reached {k} live / {miners} "
                           f"miners: {m and m.to_dict()}")

    def close(self) -> None:
        import signal
        import subprocess
        for proc in self.procs.values():
            if proc.poll() is None:
                try:
                    os.kill(proc.pid, signal.SIGCONT)  # a stopped one too
                    proc.terminate()
                except OSError:
                    pass
        for proc in self.procs.values():
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)
        for fh in self._logs:
            fh.close()
        self._logs.clear()


# -------------------------------------------------------------------- CLI

def _agent_factory(fake: bool):
    """The factory of a ``miner`` or ``gateway`` process: the ``--fake``
    searcher; the host tier under ``DBMT_COMPUTE=host``; else the card,
    warmed up first (the kernels built and loaded, every launch counter
    back at 0), with the lane body and mesh of the environment."""
    if fake:
        return _InstantSearcher
    from ..utils.config import compute_from_env, mesh_from_env, peel_from_env
    from .miner import default_searcher_factory, warm_up
    if compute_from_env() == "host":
        return default_searcher_factory
    from ..models.miner_model import resolve_device
    device = resolve_device("cuda")
    body = peel_from_env()
    mesh = mesh_from_env(device)
    if len(mesh) < 2:
        mesh = ()
    warm_up(device, body, mesh)
    return lambda data: default_searcher_factory(data, device, body, mesh)


def main(argv=None) -> int:
    """``procs {replica|router|miner|gateway} <statedir> [options]``."""
    import argparse
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(prog="procs", description=__doc__)
    sub = ap.add_subparsers(dest="role", required=True)
    rep = sub.add_parser("replica")
    rep.add_argument("statedir")
    rep.add_argument("--rid", type=int, required=True)
    rep.add_argument("--port", type=int, default=0)
    rep.add_argument("--no-verify", action="store_true",
                     help="no claim verification (a cluster of fake "
                          "miners)")
    rout = sub.add_parser("router")
    rout.add_argument("statedir")
    mine = sub.add_parser("miner")
    mine.add_argument("statedir")
    mine.add_argument("--fake", action="store_true",
                      help="instant made-up answers (the control plane "
                           "alone)")
    gate = sub.add_parser("gateway")
    gate.add_argument("statedir")
    gate.add_argument("--children", type=int, default=1,
                      help="in-process child miners behind the inner "
                           "scheduler (default 1)")
    gate.add_argument("--fake", action="store_true",
                      help="instant made-up answers (the control plane "
                           "alone)")
    args = ap.parse_args(argv)

    from ..utils.config import (VerifyParams, gateway_from_env,
                                lsp_params_from_env)
    from ..utils.logging import configure_logging
    from ..utils.metrics import set_proc_identity
    configure_logging(logging.INFO)
    params = lsp_params_from_env()
    try:
        if args.role == "replica":
            kw = {"verify": VerifyParams(enabled=False)} \
                if args.no_verify else {}
            proc = ReplicaProcess(args.statedir, args.rid, port=args.port,
                                  params=params, **kw)
            if rollup_enabled():
                set_proc_identity("replica", args.rid, proc.incarnation)
            outcome = asyncio.run(proc.run())
            return FENCED_EXIT if outcome == "fenced" else 0
        if args.role == "router":
            router = Router(args.statedir)
            if rollup_enabled():
                set_proc_identity("router", 0, router.incarnation)
            asyncio.run(router.run())
            return 0
        if args.role == "gateway":
            gwp = gateway_from_env()
            if not gwp.enabled:
                logger.error("DBMT_GATEWAY=0: the gateway role is disabled "
                             "(the flat topology)")
                return 2
            gw_agent = GatewayAgent(args.statedir, params=params,
                                    searcher_factory=_agent_factory(
                                        args.fake),
                                    children=args.children, gateway=gwp)
            if rollup_enabled():
                set_proc_identity("gateway", os.getpid(),
                                  gw_agent.incarnation)
            asyncio.run(gw_agent.run())
            return 0
        agent = MinerAgent(args.statedir, params=params,
                           searcher_factory=_agent_factory(args.fake))
        if rollup_enabled():
            set_proc_identity("miner", os.getpid(), agent.incarnation)
        asyncio.run(agent.run())
        return 0
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
