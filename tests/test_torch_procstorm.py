"""The port's process storm (``lspnet.chaos.run_proc_episode``) on the CPU.

A ``ProcCluster`` of the port's processes (router, two replicas, two
miner agents on the host tier, ``DBMT_COMPUTE=host``, started one after
the other so one joins each replica; a 0.15 s beat and LSP epochs of
0.2 s, the JAX storm tests' settings) takes one episode of each
``PROC_EPISODES`` kind in turn: a replica's SIGKILL, its SIGSTOP (woken
afterwards, it sees its fence and exits ``FENCED_EXIT``) and the
router's SIGKILL. Each request is answered once, equal to the hashlib
oracle (``bitcoin.hash.scan_min``, the episode's default oracle), and
the cluster heals to two replicas and two agents between episodes.
"""

import asyncio

from distributed_bitcoinminer_tpu_torch.apps.procs import (FENCED_EXIT,
                                                           ProcCluster)
from distributed_bitcoinminer_tpu_torch.bitcoin.hash import scan_min
from distributed_bitcoinminer_tpu_torch.lsp.params import Params
from distributed_bitcoinminer_tpu_torch.lspnet.chaos import (
    PROC_EPISODES, generate_proc_storm, run_proc_episode)
from distributed_bitcoinminer_tpu_torch.utils.metrics import registry

PROC_ENV = {"DBMT_HEALTH_BEAT_S": "0.15", "DBMT_HEALTH_MISS_K": "3",
            "DBMT_EPOCH_MILLIS": "200", "DBMT_EPOCH_LIMIT": "4",
            "DBMT_COMPUTE": "host"}


def _ok() -> int:
    return int(registry().snapshot()["counters"].get(
        "client.retry_outcomes{outcome=ok}", 0))


def test_one_episode_of_each_kind_answers_once_and_exactly(tmp_path):
    params = Params(epoch_limit=4, epoch_millis=200, window_size=8,
                    max_backoff_interval=2)

    async def scenario():
        c = ProcCluster(str(tmp_path / "state"), replicas=2, miners=0,
                        env=PROC_ENV)
        c.start()
        records = []
        try:
            for i in range(2):
                c.spawn_miner(i)
                await c.wait_live(2, timeout_s=60.0, miners=i + 1)
            c.m = 2
            for i, kind in enumerate(PROC_EPISODES):
                (ep,) = generate_proc_storm(40 + i, 1, kinds=(kind,),
                                            nonce_range=(200_000, 400_000))
                epoch = c.membership().epoch
                ok0 = _ok()
                rec = await run_proc_episode(c, ep, params)
                assert _ok() - ok0 == 1
                assert tuple(rec["reply"][:2]) == scan_min(
                    ep.tenant, 0, ep.max_nonce + 1)
                assert rec["epoch_before"] == epoch
                records.append(rec)
                await c.wait_live(2, timeout_s=60.0, miners=2)
        finally:
            c.close()
        return records

    records = asyncio.run(scenario())
    by_kind = {r["kind"]: r for r in records}
    assert sorted(by_kind) == sorted(PROC_EPISODES)
    for kind in ("kill_replica", "stop_replica"):
        r = by_kind[kind]
        assert r["victim"].startswith("replica")
        assert r["fence_s"] is not None and r["epoch_after"] > \
            r["epoch_before"]
    assert by_kind["stop_replica"]["fenced_exit"] == FENCED_EXIT
    rt = by_kind["kill_router"]
    assert rt["victim"] == "router" and rt["fence_s"] is None
