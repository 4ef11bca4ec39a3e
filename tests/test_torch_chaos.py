"""The port's chaos module: the searcher wrappers, a wedged miner live,
the seeded schedules, ``ChaosMiner`` and the seeded storms.

``WedgeableSearcher`` and ``ByzantineSearcher`` on their own (the latter
against the JAX package's wrapper, call for call), then one live run over
localhost UDP: the port's server with leases at a 0.2 s floor and grace
and a 0.05 s tick, a wedged miner and an honest CPU miner, and the port's
client. The wedged miner keeps its connection alive while its chunks'
leases blow and are re-issued; its third blown lease quarantines it;
released, it serves its chunks late (the small ones it drained together
one by one, through the blocking path), which lifts the quarantine, and
the next request splits over both miners again. Every answer equals the
hashlib oracle's.

The schedules (``generate_schedule``, ``generate_proc_storm``) equal the
JAX package's for seeds 5, 11, 17, 23 and 29 over both kind sets. A
``ChaosMiner`` with a CPU factory is killed, restarted, wedged and turned
liar over localhost UDP. The seeded storms of the JAX package's
``tests/test_chaos.py`` (seeds 11 and 23; the byzantine storm, seed 29)
run over three CPU ``ChaosMiner`` handles: every answer the oracle's, one
Result reaching the client per request, the pool converging. The
process storm is ``tests/test_torch_procstorm.py``.
"""

import asyncio
import threading
import time

import pytest

from distributed_bitcoinminer_tpu.bitcoin.hash import scan_min
from distributed_bitcoinminer_tpu.lspnet import chaos as ref_chaos
from distributed_bitcoinminer_tpu_torch.apps.miner import (
    MinerWorker, default_searcher_factory)
from distributed_bitcoinminer_tpu_torch.apps.scheduler import Scheduler
from distributed_bitcoinminer_tpu_torch.apps.client import (
    submit, submit_with_retry)
from distributed_bitcoinminer_tpu_torch.bitcoin.hash import scan_until
from distributed_bitcoinminer_tpu_torch.lsp import Params
from distributed_bitcoinminer_tpu_torch.lsp.server import new_async_server
from distributed_bitcoinminer_tpu_torch.lspnet import chaos
from distributed_bitcoinminer_tpu_torch.lspnet.chaos import (
    BYZANTINE_MODES, ByzantineSearcher, WedgeableSearcher)
from distributed_bitcoinminer_tpu_torch.utils.config import (
    CacheParams, LeaseParams, RetryParams, VerifyParams)
from distributed_bitcoinminer_tpu_torch.utils.metrics import registry


class ArgminOracle:
    """An arg-min searcher over the hashlib oracle (no difficulty mode),
    counting its calls."""

    def __init__(self, data):
        self.data = data
        self.calls = 0

    def search(self, lower, upper):
        self.calls += 1
        return scan_until(self.data, lower, upper, 0)[:2]


class Oracle(ArgminOracle):
    """The same, with difficulty mode."""

    def search_until(self, lower, upper, target):
        self.calls += 1
        return scan_until(self.data, lower, upper, target)


def test_wedgeable_searcher_blocks_until_its_gate_is_set():
    gate = threading.Event()
    inner = Oracle("wedge")
    s = WedgeableSearcher(inner, gate)
    out = {}
    t = threading.Thread(target=lambda: out.update(
        argmin=s.search(0, 99), until=s.search_until(0, 99, 1 << 60)))
    t.start()
    t.join(0.1)
    assert t.is_alive() and inner.calls == 0 and not out
    gate.set()
    t.join(10)
    assert not t.is_alive()
    assert out == {"argmin": scan_until("wedge", 0, 99, 0)[:2],
                   "until": scan_until("wedge", 0, 99, 1 << 60)}
    assert WedgeableSearcher(inner).gate.is_set()   # default: open


def test_wrappers_hide_search_until_like_the_jax_ones():
    for wrap in (lambda i: WedgeableSearcher(i),
                 lambda i: ByzantineSearcher(i, "d", "sentinel",
                                             threading.Event()),
                 lambda i: ref_chaos.WedgeableSearcher(i),
                 lambda i: ref_chaos.ByzantineSearcher(
                     i, "d", "sentinel", threading.Event())):
        assert getattr(wrap(Oracle("d")), "search_until", None) is not None
        assert getattr(wrap(ArgminOracle("d")), "search_until",
                       None) is None


@pytest.mark.parametrize("mode", BYZANTINE_MODES)
def test_byzantine_searcher_lies_like_the_jax_one(mode):
    """Call for call, with the lie flag set, cleared and set again, the
    port's wrapper answers what the JAX package's answers."""
    assert BYZANTINE_MODES == ref_chaos.BYZANTINE_MODES
    data = "byzantine"
    flag, ref_flag = threading.Event(), threading.Event()
    port = ByzantineSearcher(Oracle(data), data, mode, flag)
    ref = ref_chaos.ByzantineSearcher(Oracle(data), data, mode, ref_flag)
    calls = [("search", 0, 99), ("search_until", 100, 199, 1 << 62),
             ("search", 7, 7), ("search_until", 40, 900, 1 << 50),
             ("search", 300, 420)]
    for lying in (True, False, True):
        for f in (flag, ref_flag):
            f.set() if lying else f.clear()
        for name, *args in calls * 2:
            got = getattr(port, name)(*args)
            assert got == getattr(ref, name)(*args), (mode, name, args)
            if not lying:
                want = scan_until(data, args[0], args[1],
                                  args[2] if len(args) > 2 else 0)
                assert got == (want if len(args) > 2 else want[:2])
    with pytest.raises(ValueError):
        ByzantineSearcher(Oracle(data), data, "polite", flag)


def test_wedged_miner_served_live_over_udp():
    """A wedged miner beside an honest one: its leases blow and its
    chunks are re-issued, the third blow quarantines it, and once
    released it answers late, which lifts the quarantine."""
    params = Params(epoch_limit=5, epoch_millis=50, window_size=5,
                    max_backoff_interval=2)
    gate = threading.Event()

    def wedged(data):
        return WedgeableSearcher(default_searcher_factory(data, "cpu"),
                                 gate)

    def honest(data):
        return default_searcher_factory(data, "cpu")

    async def until(cond, timeout=20.0):
        deadline = asyncio.get_running_loop().time() + timeout
        while not cond():
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.01)

    async def scenario():
        server = await new_async_server(0, params)
        sched = Scheduler(server, lease=LeaseParams(
            grace_s=0.2, floor_s=0.2, tick_s=0.05),
            verify=VerifyParams(audit_p=0.0))
        tasks = [asyncio.create_task(sched.run())]
        hostport = f"127.0.0.1:{server.port}"
        workers = []
        try:
            for factory in (wedged, honest):      # W joins first
                w = MinerWorker(hostport, params=params,
                                searcher_factory=factory)
                await w.join()
                tasks.append(asyncio.create_task(w.run()))
                workers.append(w)
                await until(lambda: len(sched.miners) == len(workers))
            w_state = sched.miner_plane.find_miner(sched.miners[0].conn_id)
            for j in range(3):
                data = f"wedged {j}"
                got = await asyncio.wait_for(
                    submit(hostport, data, 3_000, params), 30)
                assert got == scan_min(data, 0, 3_001)
                assert w_state.blown_streak == j + 1
            assert sched.stats["leases_blown"] >= 3
            assert sched.stats["reissues"] >= 3
            assert sched.stats["quarantines"] >= 1 and w_state.quarantined
            assert len(w_state.pending) == 3 and workers[0].jobs_done == 0
            got = await asyncio.wait_for(
                submit(hostport, "honest alone", 2_000, params), 30)
            assert got == scan_min("honest alone", 0, 2_001)
            assert len(w_state.pending) == 3        # nothing new for W
            gate.set()
            await until(lambda: not w_state.pending)
            assert not w_state.quarantined and workers[0].jobs_done == 3
            assert workers[0].coalesced_dispatches == 0
            got = await asyncio.wait_for(
                submit(hostport, "both again", 3_000, params), 30)
            assert got == scan_min("both again", 0, 3_001)
            assert workers[0].jobs_done == 4        # split over both
            assert sched.stats["claims_failed"] == 0
        finally:
            gate.set()
            for t in tasks:
                t.cancel()
            for w in workers:
                await w.close()
            await server.close()
    asyncio.run(scenario())


# ------------------------------------------------------------- schedules

SEEDS = (5, 11, 17, 23, 29)


def _events(events):
    return [(e.at, e.action, e.subject, e.value) for e in events]


@pytest.mark.parametrize("byz", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_generate_schedule_equals_the_jax_one(seed, byz):
    kinds = chaos.BYZ_EPISODES if byz else chaos.EPISODES
    ref_kinds = ref_chaos.BYZ_EPISODES if byz else ref_chaos.EPISODES
    assert kinds == ref_kinds
    names = ["alpha", "beta", "gamma"]
    for args, kw in (((seed, 3.0, names), {}),
                     ((seed, 8.0, names), dict(episodes=6, max_percent=25)),
                     ((seed, 3.0, names[:2]), dict(episodes=5,
                                                   max_percent=20))):
        got = chaos.generate_schedule(*args, kinds=kinds, **kw)
        assert _events(got) == _events(ref_chaos.generate_schedule(
            *args, kinds=ref_kinds, **kw))
        assert got == chaos.generate_schedule(*args, kinds=kinds, **kw)


@pytest.mark.parametrize("seed", SEEDS)
def test_generate_proc_storm_equals_the_jax_one(seed):
    assert chaos.PROC_EPISODES == ref_chaos.PROC_EPISODES
    for kw in ({}, {"kinds": ("kill_replica",)},
               {"nonce_range": (1 << 33, 1 << 34)}):
        got = chaos.generate_proc_storm(seed, 4, **kw)
        ref = ref_chaos.generate_proc_storm(seed, 4, **kw)
        assert [(e.kind, e.fault_at, e.max_nonce, e.tenant) for e in got] \
            == [(e.kind, e.fault_at, e.max_nonce, e.tenant) for e in ref]


# ------------------------------------------------------------ ChaosMiner

def chaos_params():
    return Params(epoch_limit=4, epoch_millis=40, window_size=5,
                  max_backoff_interval=2)


def tight_lease(quarantine_after=3):
    return LeaseParams(grace_s=0.6, factor=4.0, floor_s=0.3, tick_s=0.05,
                       quarantine_after=quarantine_after, ewma_alpha=0.5)


def cpu_factory(delay: float = 0.02):
    """The port's CPU searcher, each call delayed (race windows)."""
    class Slow:
        def __init__(self, data):
            self._inner = default_searcher_factory(data, "cpu")

        def search(self, lower, upper):
            time.sleep(delay)
            return self._inner.search(lower, upper)

        def search_until(self, lower, upper, target):
            time.sleep(delay)
            return self._inner.search_until(lower, upper, target)
    return Slow


class Pool:
    """A port scheduler on a localhost LSP server and ChaosMiners."""

    def __init__(self, verify=None):
        self.params = chaos_params()
        self.verify = verify or VerifyParams(enabled=True, audit_p=0.0)
        self.miners = {}

    async def __aenter__(self):
        self.server = await new_async_server(0, self.params)
        self.sched = Scheduler(self.server, lease=tight_lease(),
                               verify=self.verify,
                               cache=CacheParams(enabled=False))
        self._task = asyncio.create_task(self.sched.run())
        self.hostport = f"127.0.0.1:{self.server.port}"
        return self

    async def __aexit__(self, *exc):
        for m in self.miners.values():
            await m.close()
        self._task.cancel()
        await self.server.close()

    async def add(self, name, **kw):
        m = chaos.ChaosMiner(self.hostport, params=self.params,
                             searcher_factory=cpu_factory(), name=name,
                             **kw)
        await m.start()
        await self.joined(m)
        self.miners[name] = m
        return m

    async def joined(self, m):
        for _ in range(500):
            if self.sched.miner_plane.find_miner(m.conn_id) is not None:
                return
            await asyncio.sleep(0.01)
        raise AssertionError(f"{m.name} never joined")

    async def settle(self, timeout=12.0):
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        s = self.sched
        while loop.time() < deadline:
            if (s.current is None and not s.tenant_plane.requests()
                    and not s.miner_plane.parked and s.miners
                    and all(m.available for m in s.miners)):
                return True
            await asyncio.sleep(0.02)
        return False


def _counter(key):
    return int(registry().snapshot()["counters"].get(key, 0))


async def _submit_once(pool, data, max_nonce, target=0):
    """``submit_with_retry`` with the JAX storms' retry settings; checks
    that one Result reached the caller and that the scheduler wrote at
    most one a connection attempted."""
    sent0 = pool.sched.stats["results_sent"]
    att0 = _counter("client.retry_attempts")
    ok0 = _counter("client.retry_outcomes{outcome=ok}")
    got = await asyncio.wait_for(submit_with_retry(
        pool.hostport, data, max_nonce, target, pool.params,
        RetryParams(attempts=8, timeout_s=2.5, backoff_s=0.1,
                    backoff_cap_s=0.5)), 40)
    attempts = _counter("client.retry_attempts") - att0
    assert _counter("client.retry_outcomes{outcome=ok}") - ok0 == 1
    assert 1 <= pool.sched.stats["results_sent"] - sent0 <= attempts
    return got


def test_chaos_miner_kill_restart_wedge_and_lie_over_udp():
    async def scenario():
        async with Pool(VerifyParams(enabled=True, audit_p=0.0)) as p:
            a = await p.add("alpha", byzantine="wrong_hash")
            b = await p.add("beta")
            first = a.conn_id
            assert a.alive and first and b.conn_id != first
            got = await asyncio.wait_for(
                submit(p.hostport, "chaos one", 2_000, p.params), 20)
            assert got == scan_min("chaos one", 0, 2_001)
            await a.kill()
            assert not a.alive and a.conn_id == 0
            for _ in range(300):          # the epoch timer drops it
                if p.sched.miner_plane.find_miner(first) is None:
                    break
                await asyncio.sleep(0.01)
            assert p.sched.miner_plane.find_miner(first) is None
            await a.restart()
            await p.joined(a)
            assert a.alive and a.restarts == 1 and a.conn_id != first
            a.wedge()
            assert a.wedged
            got = await asyncio.wait_for(
                submit(p.hostport, "chaos two", 2_000, p.params), 20)
            assert got == scan_min("chaos two", 0, 2_001)
            assert p.sched.stats["leases_blown"] >= 1
            assert p.sched.stats["reissues"] >= 1
            a.unwedge()
            assert await p.settle()
            a.go_byzantine()
            assert a.lying
            got = await asyncio.wait_for(
                submit(p.hostport, "chaos three", 2_000, p.params), 20)
            assert got == scan_min("chaos three", 0, 2_001)
            assert p.sched.stats["claims_failed"] >= 1
            a.go_honest()
            assert not a.lying
            assert await p.settle()
    asyncio.run(scenario())


# --------------------------------------------------------- seeded storms

@pytest.mark.parametrize("seed", [11, 23])
def test_seeded_storm_every_answer_exact_once_and_pool_converges(seed):
    """The JAX headline storm: kills, wedges, one-sided partitions and
    the drop and delay knobs over three miners while a client submits."""
    async def scenario():
        chaos.seed_packet_faults(seed)
        async with Pool() as p:
            for name in ("alpha", "beta", "gamma"):
                await p.add(name)
            schedule = chaos.generate_schedule(
                seed, 3.0, list(p.miners), episodes=5, max_percent=25)
            storm = asyncio.create_task(chaos.run_schedule(schedule,
                                                           p.miners))
            try:
                for data, max_nonce in (("storm one", 399),
                                        ("storm two", 499),
                                        ("storm three", 299),
                                        ("storm four", 449)):
                    got = await _submit_once(p, data, max_nonce)
                    assert got[:2] == scan_min(data, 0, max_nonce + 1)
            finally:
                assert await asyncio.wait_for(storm, 20) == len(schedule)
            assert await p.settle()
    asyncio.run(scenario())


def test_seeded_byzantine_storm_answers_exactly():
    """The JAX byzantine storm (seed 29): a ``wrong_hash`` and a
    ``sentinel`` miner beside an honest one, turn-coat episodes with
    wedges and delays, every arg-min chunk audited."""
    seed = 29

    async def scenario():
        chaos.seed_packet_faults(seed)
        async with Pool(VerifyParams(enabled=True, audit_p=1.0,
                                     audit_max_nonces=1 << 20)) as p:
            await p.add("alpha", byzantine="wrong_hash")
            await p.add("beta", byzantine="sentinel")
            await p.add("gamma")
            schedule = chaos.generate_schedule(
                seed, 3.0, ["alpha", "beta"], episodes=5, max_percent=20,
                kinds=("byzantine", "wedge", "delay"))
            assert any(e.action == "byzantine" for e in schedule)
            storm = asyncio.create_task(chaos.run_schedule(schedule,
                                                           p.miners))
            try:
                for data, max_nonce in (("turncoat one", 399),
                                        ("turncoat two", 299),
                                        ("turncoat three", 449)):
                    got = await _submit_once(p, data, max_nonce)
                    assert got[:2] == scan_min(data, 0, max_nonce + 1)
            finally:
                await asyncio.wait_for(storm, 20)
            assert await p.settle()
            assert p.sched.stats["claims_checked"] > 0
            assert p.sched.stats["audits_issued"] > 0
    asyncio.run(scenario())
