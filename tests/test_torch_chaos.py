"""The port's fault-injecting searcher wrappers, and a wedged miner live.

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
"""

import asyncio
import threading

import pytest

from distributed_bitcoinminer_tpu.bitcoin.hash import scan_min
from distributed_bitcoinminer_tpu.lspnet import chaos as ref_chaos
from distributed_bitcoinminer_tpu_torch.apps.miner import (
    MinerWorker, default_searcher_factory)
from distributed_bitcoinminer_tpu_torch.apps.scheduler import Scheduler
from distributed_bitcoinminer_tpu_torch.apps.client import submit
from distributed_bitcoinminer_tpu_torch.bitcoin.hash import scan_until
from distributed_bitcoinminer_tpu_torch.lsp import Params
from distributed_bitcoinminer_tpu_torch.lsp.server import new_async_server
from distributed_bitcoinminer_tpu_torch.lspnet.chaos import (
    BYZANTINE_MODES, ByzantineSearcher, WedgeableSearcher)
from distributed_bitcoinminer_tpu_torch.utils.config import (LeaseParams,
                                                             VerifyParams)


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
