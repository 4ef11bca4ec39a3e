"""The federation against the JAX package's: the GatewayMiner, the
repeat-JOIN refresh, and the gateway's entry point.

``aggregate_rate_hint`` and ``MinerPlane.refresh_rate_hint`` against the
JAX functions on the cases of ``tests/test_federation.py``; the
scheduler's repeat-JOIN branch held to the JAX scheduler event for event
(the lockstep ``Pair`` of ``tests/test_torch_sched.py``) with
``DBMT_GATEWAY`` on and off; ``ReplicaSet`` routing a repeat JOIN to its
owner, against the JAX ``ReplicaSet``; then a live ``GatewayMiner`` over
the port's LSP on localhost with CPU child miners: arg-min and
difficulty answers equal to the oracle with no failed claim at the
parent, the bridge conn killed with grants pending (exactly-once replies
in order), the orphan watchdog, and ``serve`` refusing under
``DBMT_GATEWAY=0``. Every live wait is bounded.
"""

import asyncio
from types import SimpleNamespace

import pytest

from distributed_bitcoinminer_tpu.apps import gateway as ref_gateway
from distributed_bitcoinminer_tpu.apps.miner_plane import \
    MinerPlane as RefMinerPlane
from distributed_bitcoinminer_tpu.bitcoin.hash import scan_min, scan_until
from distributed_bitcoinminer_tpu.utils import config as ref_config
from distributed_bitcoinminer_tpu.utils.metrics import \
    Registry as RefRegistry
from distributed_bitcoinminer_tpu_torch.apps import gateway, procs
from distributed_bitcoinminer_tpu_torch.apps.client import (submit,
                                                            submit_until)
from distributed_bitcoinminer_tpu_torch.apps.miner import (HostSearcher,
                                                           MinerWorker)
from distributed_bitcoinminer_tpu_torch.apps.miner_plane import MinerPlane
from distributed_bitcoinminer_tpu_torch.apps.scheduler import Scheduler
from distributed_bitcoinminer_tpu_torch.bitcoin.message import (
    Message, MsgType, new_join, new_request)
from distributed_bitcoinminer_tpu_torch.lsp.client import new_async_client
from distributed_bitcoinminer_tpu_torch.lsp.server import new_async_server
from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
from distributed_bitcoinminer_tpu_torch.utils import config
from distributed_bitcoinminer_tpu_torch.utils.metrics import Registry
from tests.test_torch_apps import fast_params
from tests.test_torch_replicas import Sets
from tests.test_torch_sched import (MINER_A, MINER_B, TEN_X, TEN_Y, Pair,
                                    clock)  # noqa: F401


# ------------------------------------------------------- the pool's hint


def _sched(*miners):
    return SimpleNamespace(miner_plane=SimpleNamespace(miners=list(miners)))


def _miner(rate, quarantined=False):
    return SimpleNamespace(rate_ewma=rate, quarantined=quarantined)


@pytest.mark.parametrize("scheds", [
    [_sched(_miner(1000.0), _miner(None), _miner(500.0, True)),
     _sched(_miner(250.0))],
    [_sched(_miner(None), _miner(None))],
    [_sched(_miner(1e15), _miner(1e15))],
    [_sched(_miner(3.5, True))], []])
def test_aggregate_rate_hint_equals_jax(scheds):
    got = gateway.aggregate_rate_hint(scheds)
    assert got == ref_gateway.aggregate_rate_hint(scheds)
    assert got <= MinerPlane.RATE_HINT_CAP == RefMinerPlane.RATE_HINT_CAP


class _Planes:
    """A port MinerPlane and a JAX one with recording stubs."""

    def __init__(self):
        self.counts = ({}, {})

        def count(side):
            def _count(name, n=1):
                self.counts[side][name] = self.counts[side].get(name, 0) + n
            return _count
        self.port = MinerPlane(
            Registry(), config.LeaseParams(grace_s=5.0, floor_s=2.0),
            config.CoalesceParams(enabled=False), write=lambda c, m: None,
            inflight={}, lease_event=lambda *a, **k: None,
            dispatch=lambda: None, count=count(0),
            stripe=config.StripeParams(enabled=False))
        self.ref = RefMinerPlane(
            RefRegistry(), count(1),
            ref_config.LeaseParams(grace_s=5.0, floor_s=2.0),
            ref_config.StripeParams(enabled=False),
            ref_config.CoalesceParams(enabled=False),
            write=lambda c, m: None, inflight={},
            trace_get=lambda job: None,
            lease_event=lambda kind, chunk, conn, **info: None,
            dispatch=lambda: None)

    def both(self, fn):
        out = [fn(self.port), fn(self.ref)]
        pm, rm = self.port.miners, self.ref.miners
        assert [(m.conn_id, m.rate_ewma, m.rate_hinted, m.trust)
                for m in pm] == [(m.conn_id, m.rate_ewma, m.rate_hinted,
                                  m.trust) for m in rm]
        assert self.counts[0].get("rate_hints_refreshed") == \
            self.counts[1].get("rate_hints_refreshed")
        return out

    def set(self, conn, **fields):
        for plane in (self.port, self.ref):
            m = plane.find_miner(conn)
            for k, v in fields.items():
                setattr(m, k, v)


REFRESH_CASES = {
    # A hint-only EWMA is replaced in place.
    "hinted": (1000.0, {}, [2000.0, 500.0]),
    # A measured one outranks claims within [0.5x, 2x), not beyond.
    "measured": (0.0, {"rate_ewma": 1000.0, "rate_hinted": False},
                 [1600.0, 600.0, 5000.0]),
    "shrank": (0.0, {"rate_ewma": 1000.0, "rate_hinted": False},
               [400.0, 1200.0]),
    # Trust scales a refresh; the cap clamps it; 0 or less is nothing.
    "trust_cap": (1000.0, {"trust": 0.25},
                  [2000.0, 10 * MinerPlane.RATE_HINT_CAP, 0.0, -3.0]),
}


@pytest.mark.parametrize("case", sorted(REFRESH_CASES))
def test_refresh_rate_hint_equals_jax(case):
    join_hint, fields, refreshes = REFRESH_CASES[case]
    p = _Planes()
    p.both(lambda plane: plane.on_join(7, rate_hint=join_hint))
    p.set(7, **fields)
    for hint in refreshes:
        p.both(lambda plane: plane.refresh_rate_hint(plane.find_miner(7),
                                                     hint))
    assert len(p.port.miners) == 1


@pytest.mark.parametrize("flag", ["1", "0"])
def test_repeat_join_branch_equals_jax_scheduler(clock, monkeypatch, flag):
    """Joins, repeat JOINs with and without a hint, requests and answers,
    in lockstep: with the knob on a repeat JOIN refreshes the entry in
    place; off, it registers a second entry, in both packages."""
    monkeypatch.setenv("DBMT_GATEWAY", flag)
    monkeypatch.setenv("DBM_GATEWAY", flag)
    p = Pair(clock)
    p.join(MINER_A, rate=10 ** 6)
    p.join(MINER_B)
    p.request(TEN_X, "gateway", 3_000)
    p.join(MINER_A, rate=4 * 10 ** 6)
    p.join(MINER_B)                       # a hintless repeat JOIN
    p.request(TEN_Y, "gateway y", 2_000, target=1 << 60)
    if flag == "0":
        # Each JOIN registered a miner: the first entries' chunks can no
        # longer be answered (a Result pops the conn's newest entry), as
        # in the reference's scheduler.
        assert [m.conn_id for m in p.port.miners] == \
            [MINER_A, MINER_B, MINER_A, MINER_B]
        assert p.port.stats["rate_hints_refreshed"] == 0
        return
    clock.step(0.5)
    p.drain()
    p.join(MINER_A, rate=10 ** 9)
    p.request(TEN_X, "gateway z", 5_000)
    p.drain()
    assert [m.conn_id for m in p.port.miners] == [MINER_A, MINER_B]
    assert p.port.stats["rate_hints_refreshed"] == 2
    assert p.replies(TEN_X) == [scan_min("gateway", 0, 3_001),
                                scan_min("gateway z", 0, 5_001)]
    assert p.replies(TEN_Y) == [scan_until("gateway y", 0, 2_001,
                                           1 << 60)[:2]]


@pytest.mark.parametrize("flag", ["1", "0"])
def test_replica_set_routes_a_repeat_join_to_its_owner(clock, monkeypatch,
                                                       flag):
    monkeypatch.setenv("DBMT_GATEWAY", flag)
    monkeypatch.setenv("DBM_GATEWAY", flag)
    s = Sets(clock)
    s.route(101, new_join(rate=1000).to_json())
    s.join(102)
    owner = s.port._miner_owner[101]
    s.route(101, new_join(rate=9000).to_json())
    rosters = {rid: [m.conn_id for m in r.miners]
               for rid, r in s.port.replicas.items()}
    if flag == "1":
        assert s.port._miner_owner[101] == owner
        assert sorted(sum(rosters.values(), [])) == [101, 102]
        miner = s.port.replicas[owner].miner_plane.find_miner(101)
        assert miner.rate_ewma == 9000.0
    else:
        # A second registration, on the then thinnest replica.
        assert sorted(sum(rosters.values(), [])) == [101, 101, 102]
        return
    s.request(1, "tenant 1", 4_000)
    s.drain()
    assert s.replies(1) == [scan_min("tenant 1", 0, 4_001)]


# ------------------------------------------------------ a live gateway


class Fed:
    """A parent scheduler, an inner one and a GatewayMiner between them,
    with CPU child miners on the inner tier, all over the port's LSP on
    localhost in one event loop."""

    def __init__(self, children=(("torch", 10 ** 9), ("host", 0)),
                 **gw_params):
        self.params = fast_params()
        self.children = children
        self.gw_params = config.GatewayParams(**{"hint_s": 0.2,
                                                 **gw_params})
        self.tasks, self.workers = [], []

    async def __aenter__(self):
        self.parent_server = await new_async_server(0, self.params)
        self.parent = Scheduler(self.parent_server,
                                verify=config.VerifyParams(audit_p=0.0))
        self.inner_server = await new_async_server(0, self.params)
        self.inner = Scheduler(self.inner_server,
                               verify=config.VerifyParams(audit_p=0.0))
        self.tasks += [asyncio.ensure_future(self.parent.run()),
                       asyncio.ensure_future(self.inner.run())]
        inner = f"127.0.0.1:{self.inner_server.port}"
        for kind, hint in self.children:
            await self.add_child(kind, hint)
        self.gw = gateway.GatewayMiner(
            parent_connect=lambda: new_async_client(self.hostport,
                                                    self.params),
            bridge_connect=lambda: new_async_client(inner, self.params),
            inner_scheds=[self.inner], params=self.gw_params,
            backoff_s=0.05)
        self.tasks.append(asyncio.ensure_future(self.gw.run_forever()))
        await self.until(lambda: len(self.parent.miners) == 1)
        self.join_hint = self.gw._last_hint
        return self

    async def add_child(self, kind, hint=0):
        def factory(data):
            return HostSearcher(data) if kind == "host" \
                else NonceSearcher(data, device="cpu")
        w = MinerWorker(f"127.0.0.1:{self.inner_server.port}",
                        params=self.params, searcher_factory=factory,
                        rate_hint=hint)
        await w.join()
        self.tasks.append(asyncio.ensure_future(w.run()))
        self.workers.append(w)

    async def __aexit__(self, *exc):
        for t in self.tasks:
            t.cancel()
        await asyncio.gather(*self.tasks, return_exceptions=True)
        for w in self.workers:
            await w.close()
        await self.inner_server.close()
        await self.parent_server.close()

    @property
    def hostport(self):
        return f"127.0.0.1:{self.parent_server.port}"

    @staticmethod
    async def until(cond, timeout=20.0):
        deadline = asyncio.get_running_loop().time() + timeout
        while not cond():
            assert asyncio.get_running_loop().time() < deadline, \
                "condition not met in time"
            await asyncio.sleep(0.01)


def test_gateway_serves_the_parent_as_one_miner():
    async def scenario():
        async with Fed() as f:
            got = await asyncio.wait_for(
                submit(f.hostport, "cmu440", 60_000, f.params), 60)
            assert got == scan_min("cmu440", 0, 60_001)
            target = 1 << 57
            until = await asyncio.wait_for(
                submit_until(f.hostport, "cmu440", 60_000, target,
                             f.params), 60)
            assert until == (*scan_until("cmu440", 0, 60_001, target)[:2],
                             True)
            miss = await asyncio.wait_for(
                submit_until(f.hostport, "x", 3_000, 1, f.params), 60)
            assert miss == (*scan_min("x", 0, 3_001), False)
            # One miner at the parent; the inner pool did the work.
            assert [m.conn_id for m in f.parent.miners] == \
                [f.parent.miners[0].conn_id]
            assert f.parent.stats["claims_failed"] == 0
            assert f.parent.stats["claims_checked"] >= 3
            assert f.gw.results_forwarded == f.gw.grants_taken >= 3
            assert sum(w.jobs_done for w in f.workers) >= 3
            # The JOIN carried the pool's hint (the first child's, less
            # the 2% a sweep an unconfirmed hint decays); a child joining
            # with a hint 2x off anything the parent holds moves the sum,
            # the hint loop re-sends the JOIN, and the parent takes it
            # into its one entry in place.
            assert 10 ** 9 * 0.98 ** 20 <= f.join_hint <= 10 ** 9
            await f.add_child("host", 10 ** 11)
            await f.until(lambda: f.gw._last_hint > 10 ** 11)
            await f.until(lambda: (f.parent.miners[0].rate_ewma or 0)
                          > 0.9 * 10 ** 11)
            assert f.gw.hint_refreshes >= 1
            assert f.parent.stats["rate_hints_refreshed"] >= 1
            assert len(f.parent.miners) == 1
    asyncio.run(scenario())


def test_bridge_death_resubmits_in_order_exactly_once():
    async def scenario():
        async with Fed(children=(("torch", 0),)) as f:
            client = await new_async_client(f.hostport, f.params)
            jobs = [("bridge a", 40_000), ("bridge b", 30_000),
                    ("bridge c", 20_000)]
            for data, mx in jobs:
                client.write(new_request(data, 0, mx).to_json())
            await f.until(lambda: f.gw._pending)
            await f.gw._bridge.close()    # kill it with a grant pending
            replies = []
            for _ in jobs:
                msg = Message.from_json(
                    await asyncio.wait_for(client.read(), 60))
                assert msg.type == MsgType.RESULT
                replies.append((msg.hash, msg.nonce))
            assert replies == [scan_min(d, 0, mx + 1) for d, mx in jobs]
            with pytest.raises(asyncio.TimeoutError):
                await asyncio.wait_for(client.read(), 0.5)
            await client.close()
            assert f.parent.stats["claims_failed"] == 0
            assert f.parent.stats["results_sent"] == len(jobs)
    asyncio.run(scenario())


def test_orphan_watchdog_drops_the_parent_conn():
    async def scenario():
        async with Fed(children=(("host", 0),), orphan_s=0.3) as f:
            miner_conn = f.parent.miners[0].conn_id
            for w in f.workers:            # the inner pool empties
                await w.close()
            await f.until(lambda: not f.inner.miners)
            client = await new_async_client(f.hostport, f.params)
            client.write(new_request("orphan", 0, 5_000).to_json())
            await f.until(lambda: f.gw.orphan_drops == 1)
            await f.until(lambda: all(m.conn_id != miner_conn
                                      for m in f.parent.miners))
            await client.close()
    asyncio.run(scenario())


@pytest.mark.parametrize("env", [
    {}, {"GATEWAY": "0", "GATEWAY_HINT_S": "0.01",
         "GATEWAY_MIN_POOL": "0", "GATEWAY_ORPHAN_S": "0"},
    {"GATEWAY_HINT_S": "5", "GATEWAY_MIN_POOL": "3",
     "GATEWAY_ORPHAN_S": "junk"}])
def test_gateway_reader_equals_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(f"DBMT_{k}", v)
        monkeypatch.setenv(f"DBM_{k}", v)
    got, want = config.gateway_from_env(), ref_config.gateway_from_env()
    assert (got.enabled, got.hint_s, got.min_pool, got.orphan_s) == \
        (want.enabled, want.hint_s, want.min_pool, want.orphan_s)


def test_serve_refuses_under_gateway_off(monkeypatch):
    from distributed_bitcoinminer_tpu_torch.utils import logging as dlog
    monkeypatch.setenv("DBMT_GATEWAY", "0")
    with pytest.raises(RuntimeError, match="DBMT_GATEWAY=0"):
        asyncio.run(gateway.serve("127.0.0.1:1"))
    # The procs role too (its stderr handler left out of the test).
    monkeypatch.setattr(dlog, "configure_logging", lambda *a, **k: None)
    assert procs.main(["gateway", "/nonexistent/state"]) == 2
