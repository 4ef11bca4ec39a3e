"""The port's scheduler, miner and client end to end over localhost UDP.

Every scenario binds ephemeral ports and uses fast LSP params. Answers
are held against the hashlib oracle over the range the system scans,
``[0, maxNonce + 1]`` (the scheduler sends exclusive upper bounds that
miners read as inclusive, the reference's quirk). The interop scenarios
mix the port's processes with the JAX package's, byte for byte on the
wire.
"""

import asyncio
import time

import pytest

from distributed_bitcoinminer_tpu.apps.miner import HostSearcher
from distributed_bitcoinminer_tpu.apps.miner import \
    MinerWorker as RefMinerWorker
from distributed_bitcoinminer_tpu.apps.scheduler import \
    Scheduler as RefScheduler
from distributed_bitcoinminer_tpu.bitcoin.hash import scan_min
from distributed_bitcoinminer_tpu.lsp.server import \
    new_async_server as ref_new_async_server
from distributed_bitcoinminer_tpu_torch.apps import client as port_client
from distributed_bitcoinminer_tpu_torch.apps import miner as port_miner
from distributed_bitcoinminer_tpu_torch.apps.client import (
    printable_result, submit)
from distributed_bitcoinminer_tpu_torch.apps.miner import (
    MinerWorker, default_searcher_factory)
from distributed_bitcoinminer_tpu_torch.apps.scheduler import Scheduler
from distributed_bitcoinminer_tpu_torch.lsp import Params
from distributed_bitcoinminer_tpu_torch.lsp.server import new_async_server
from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
from distributed_bitcoinminer_tpu_torch.ops import sha256_cuda
from distributed_bitcoinminer_tpu_torch.utils.config import VerifyParams


def fast_params(epoch_ms=50, limit=5, window=5):
    return Params(epoch_limit=limit, epoch_millis=epoch_ms,
                  window_size=window, max_backoff_interval=2)


def expected(data, max_nonce):
    return scan_min(data, 0, max_nonce + 1)


def cpu_factory(delay: float = 0.0):
    """The port's searcher on the CPU, its arg-min search optionally
    slowed down (``search`` for the serial miner, ``dispatch`` for the
    pipelined one)."""
    def make(data):
        s = default_searcher_factory(data, device="cpu")
        if delay:
            for name in ("search", "dispatch"):
                def slow(lower, upper, _fn=getattr(s, name)):
                    time.sleep(delay)
                    return _fn(lower, upper)
                setattr(s, name, slow)
        return s
    return make


class Cluster:
    """A scheduler (the port's, or the JAX package's) plus miners."""

    def __init__(self, params, ref_scheduler=False, qos=None):
        self.params = params
        self.ref_scheduler = ref_scheduler
        self.qos = qos             # the port scheduler's QosParams
        self.tasks = []
        self.miners = []

    async def __aenter__(self):
        if self.ref_scheduler:
            self.server = await ref_new_async_server(0, self.params)
            self.scheduler = RefScheduler(self.server)
        else:
            self.server = await new_async_server(0, self.params)
            # No random audits: they would add chunks to the miners'
            # counts that the scenarios pin.
            self.scheduler = Scheduler(self.server, qos=self.qos,
                                       verify=VerifyParams(audit_p=0.0))
        self.tasks.append(asyncio.create_task(self.scheduler.run()))
        return self

    async def __aexit__(self, *exc):
        for task in self.tasks:
            task.cancel()
        for worker in self.miners:
            await worker.close()
        await self.server.close()

    @property
    def hostport(self):
        return f"127.0.0.1:{self.server.port}"

    async def start_miner(self, factory=None, worker=None):
        worker = worker or MinerWorker(self.hostport, params=self.params,
                                       searcher_factory=factory
                                       or cpu_factory())
        await worker.join()
        self.tasks.append(asyncio.create_task(worker.run()))
        self.miners.append(worker)
        return worker


def test_port_server_miner_client_end_to_end():
    sha256_cuda.reset_launches()

    async def scenario():
        async with Cluster(fast_params()) as c:
            miner = await c.start_miner()
            r1 = await asyncio.wait_for(
                submit(c.hostport, "cmu440", 12_000, c.params), 30)
            r2 = await asyncio.wait_for(
                submit(c.hostport, "x" * 60, 1_500, c.params), 30)
            assert r1 == expected("cmu440", 12_000)
            assert r2 == expected("x" * 60, 1_500)
            assert c.scheduler.stats["claims_failed"] == 0
            assert c.scheduler.stats["claims_checked"] == 2
            counts = miner.counts()
            assert counts["chunks"] == 2
            assert counts["coalesced_dispatches"] == 0
            assert counts["kernel_launches"] == {"K1": 0, "K2": 0, "K3": 0,
                                                 "K4": 0, "K5": 0, "K6": 0,
                                                 "K6mesh": 0}
            assert sum(s.device_launches
                       for s in miner._searchers.values()) == 9
    asyncio.run(scenario())
    assert sha256_cuda.total_launches() == 0


def test_fifo_queue_and_even_split_over_miners():
    async def scenario():
        async with Cluster(fast_params()) as c:
            for _ in range(3):
                await c.start_miner()
            results = await asyncio.wait_for(asyncio.gather(
                submit(c.hostport, "msg one", 500, c.params),
                submit(c.hostport, "msg two", 700, c.params),
                submit(c.hostport, "msg three", 90, c.params)), 30)
            assert results == [expected("msg one", 500),
                               expected("msg two", 700),
                               expected("msg three", 90)]
            assert c.scheduler.stats["results_sent"] == 3
            assert [m.jobs_done for m in c.miners] == [3, 3, 3]
    asyncio.run(scenario())


def test_killed_miner_mid_request_same_answer():
    async def scenario():
        params = fast_params(epoch_ms=40, limit=3)
        async with Cluster(params) as c:
            victim = await c.start_miner(cpu_factory(delay=1.5))
            await c.start_miner()
            pending = asyncio.create_task(
                submit(c.hostport, "fault tolerant", 4_000, params))
            await asyncio.sleep(0.3)  # both miners now hold chunks
            # Crash the slow miner without a graceful close: silence makes
            # the server's epoch timer declare it lost.
            victim.client._conn.abort()
            victim.client._ep.close()
            assert await asyncio.wait_for(pending, 30) == \
                expected("fault tolerant", 4_000)
            assert len(c.scheduler.miners) == 1
    asyncio.run(scenario())


def test_client_drop_cancels_and_frees_pool():
    async def scenario():
        params = fast_params(epoch_ms=40, limit=3)
        async with Cluster(params) as c:
            await c.start_miner(cpu_factory(delay=0.5))
            doomed = asyncio.create_task(
                submit(c.hostport, "abandoned", 3_000, params))
            await asyncio.sleep(0.2)
            doomed.cancel()
            await asyncio.sleep(0.6)
            assert await asyncio.wait_for(
                submit(c.hostport, "next", 200, params), 30) == \
                expected("next", 200)
    asyncio.run(scenario())


def test_empty_and_inverted_requests_do_not_wedge():
    async def scenario():
        async with Cluster(fast_params()) as c:
            await c.start_miner()
            c.scheduler._on_request(-1, type("M", (), {
                "data": "x", "lower": 5, "upper": 1, "target": 0})())
            assert c.scheduler.current is None
            assert await asyncio.wait_for(
                submit(c.hostport, "after", 0, c.params), 30) == \
                expected("after", 0)
    asyncio.run(scenario())


def test_port_miner_under_jax_scheduler_passes_claim_checks():
    async def scenario():
        async with Cluster(fast_params(), ref_scheduler=True) as c:
            for _ in range(2):
                await c.start_miner()
            result = await asyncio.wait_for(
                submit(c.hostport, "interop", 6_000, c.params), 30)
            assert result == expected("interop", 6_000)
            assert c.scheduler.stats["claims_failed"] == 0
            assert c.scheduler.stats["claims_checked"] >= 2
    asyncio.run(scenario())


def test_jax_miner_under_port_server():
    async def scenario():
        async with Cluster(fast_params()) as c:
            ref = RefMinerWorker(
                c.hostport, params=c.params, pipeline=False,
                searcher_factory=lambda data, batch: HostSearcher(data))
            await c.start_miner(worker=ref)
            await c.start_miner()
            result = await asyncio.wait_for(
                submit(c.hostport, "mixed pool", 5_000, c.params), 30)
            assert result == expected("mixed pool", 5_000)
            assert c.scheduler.stats["claims_failed"] == 0
            assert ref.jobs_done == 1
    asyncio.run(scenario())


def test_port_client_against_jax_server():
    from distributed_bitcoinminer_tpu.apps.client import \
        submit as ref_submit

    async def scenario():
        async with Cluster(fast_params(), ref_scheduler=True) as c:
            await c.start_miner(worker=RefMinerWorker(
                c.hostport, params=c.params, pipeline=False,
                searcher_factory=lambda data, batch: HostSearcher(data)))
            got = await asyncio.wait_for(
                submit(c.hostport, "client interop", 2_000, c.params), 30)
            want = await asyncio.wait_for(
                ref_submit(c.hostport, "client interop", 2_000, c.params),
                30)
            assert got == want == expected("client interop", 2_000)
    asyncio.run(scenario())


def test_cli_contracts(capsys):
    assert printable_result(None) == "Disconnected"
    assert printable_result((5, 7)) == "Result 5 7"
    assert port_client.main(["client", "h:1", "msg"]) == 1
    assert port_client.main(["client", "h:1", "msg", "+5"]) == 1
    assert "+5 is not a number." in capsys.readouterr().out
    assert port_miner.main(["miner"]) == 1
    assert port_miner.main(["miner", "h:1", "--device"]) == 1


def test_miner_cli_refuses_missing_gpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        port_miner.main(["miner", "127.0.0.1:1"])
    with pytest.raises(RuntimeError):
        port_miner.main(["miner", "127.0.0.1:1", "--device", "cuda"])


def test_miner_exits_on_broken_search_and_chunk_is_reassigned():
    class Broken:
        def search(self, lower, upper):
            raise RuntimeError("device lost")

    async def scenario():
        params = fast_params(epoch_ms=40, limit=3)
        async with Cluster(params) as c:
            await c.start_miner(lambda data: Broken())
            pending = asyncio.create_task(
                submit(c.hostport, "broken", 800, params))
            await asyncio.sleep(0.5)
            await c.start_miner()
            assert await asyncio.wait_for(pending, 30) == \
                expected("broken", 800)
    asyncio.run(scenario())


def test_searcher_cache_is_lru_bounded():
    w = MinerWorker("127.0.0.1:1", searcher_factory=cpu_factory())
    for j in range(6):
        assert isinstance(w._get_searcher(f"m{j}"), NonceSearcher)
    assert list(w._searchers) == ["m2", "m3", "m4", "m5"]
