"""The process tier against the JAX package's, and one live topology.

State and helpers across the packages: the port's ``Router`` and the JAX
one driven tick for tick over the same beat files (one fake clock, each
package on its own copy of the directory) write equal
``membership.json`` documents; ``pick_thinnest`` and ``resolve_owner``
equal; a spool written by one package ingested by the other, a fenced
incarnation's lines dropped by both; ``gc_fenced_spools`` and the
``owner_gone`` table; ``retry_from_env`` against the JAX reader.
``submit_with_retry`` against a server that dies and comes back on its
port. Then one real ``ProcCluster`` (a router, 2 replicas, 1 miner
agent, 1 gateway agent with 2 children, the host tier, a 0.2 s beat):
the ring client's request in flight survives a ``kill -9`` of its owner,
answered exactly once and equal to the JAX package's native scan, and ``tools.dbmtop
--once --json`` sees every process fresh before and the dead replica
fenced or stale after. Every wait is bounded.
"""

import asyncio
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from distributed_bitcoinminer_tpu import native as ref_native
from distributed_bitcoinminer_tpu.apps import procs as ref_procs
from distributed_bitcoinminer_tpu.bitcoin.hash import scan_min
from distributed_bitcoinminer_tpu.utils import config as ref_config
from distributed_bitcoinminer_tpu_torch.apps import health, procs
from distributed_bitcoinminer_tpu_torch.apps.client import submit_with_retry
from distributed_bitcoinminer_tpu_torch.apps.miner import MinerWorker
from distributed_bitcoinminer_tpu_torch.apps.scheduler import Scheduler
from distributed_bitcoinminer_tpu_torch.lsp.server import new_async_server
from distributed_bitcoinminer_tpu_torch.utils import config
from tests.test_torch_apps import cpu_factory, fast_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------- the router


class _Done(Exception):
    pass


def _beat(rid, inc, seq, port, miners=1):
    return health.Beat(rid=rid, incarnation=inc, seq=seq, port=port,
                       miners=miners).to_dict()


#: Beat files before each router tick: both replicas beating, replica 1
#: frozen (its seq stops) until it is fenced, then a fresh incarnation of
#: it, then replica 0 frozen too.
def _script():
    ticks = []
    for t in range(30):
        beats = {0: _beat(0, "a0", t + 1, 7000)} if t < 20 else {}
        if t < 4:
            beats[1] = _beat(1, "a1", t + 1, 7001)
        elif t >= 12:
            beats[1] = _beat(1, "b1", t, 7011, miners=2)
        ticks.append(beats)
    return ticks


def _drive_router(router, statedir, monkeypatch):
    """Run ``router.run()`` over :func:`_script`, one fake beat a tick;
    returns ``membership.json`` after each tick."""
    ticks = iter(_script())
    seen = []
    clock = [100.0]

    def write(beats):
        for rid, d in beats.items():
            procs.write_json_atomic(procs.beat_path(statedir, rid), d)

    async def fake_sleep(dt):
        seen.append(procs.read_json(procs.membership_path(statedir)))
        clock[0] += dt
        try:
            write(next(ticks))
        except StopIteration:
            raise _Done from None

    write(next(ticks))
    loop = asyncio.new_event_loop()
    loop.time = lambda: clock[0]
    with monkeypatch.context() as m:
        m.setattr(asyncio, "sleep", fake_sleep)
        with pytest.raises(_Done):
            loop.run_until_complete(router.run())
    loop.close()
    return seen


def test_router_writes_the_jax_routers_membership(tmp_path, monkeypatch):
    d, d2 = str(tmp_path / "port"), str(tmp_path / "jax")
    os.makedirs(d)
    os.makedirs(d2)
    got = _drive_router(procs.Router(d, beat_s=0.2, miss_k=3), d,
                        monkeypatch)
    want = _drive_router(ref_procs.Router(d2, beat_s=0.2, miss_k=3), d2,
                         monkeypatch)
    assert got == want
    epochs = [m["epoch"] for m in got]
    assert epochs == sorted(epochs) and epochs[-1] >= 4
    last = health.Membership.from_dict(got[-1])
    assert last.is_fenced(1, "a1") and last.is_fenced(0, "a0")
    assert list(last.live) == [1] and last.live[1]["incarnation"] == "b1"


# ---------------------------------------------------- placement and spools


def _state(d, miners, live=None, fenced=()):
    m = health.Membership()
    for rid, n in enumerate(miners):
        b = health.Beat(rid=rid, incarnation=f"i{rid}", seq=1,
                        port=7000 + rid, miners=n)
        procs.write_json_atomic(procs.beat_path(d, rid), b.to_dict())
        if live is None or rid in live:
            m.admit(b)
    for rid in fenced:
        m.declare_dead(rid)
    procs.write_json_atomic(procs.membership_path(d), m.to_dict())
    return m


@pytest.mark.parametrize("miners,live,fenced", [
    ((0, 0), None, ()), ((1, 0), None, ()), ((2, 1, 1), None, ()),
    ((3, 0, 2, 0), None, (1,)), ((1, 1, 0), (0, 2), ()),
    ((0, 4), None, (0,))])
def test_pick_thinnest_and_resolve_owner_equal_jax(tmp_path, miners, live,
                                                   fenced):
    d = str(tmp_path)
    assert procs.pick_thinnest(d) is None is ref_procs.pick_thinnest(d)
    _state(d, miners, live, fenced)
    assert procs.pick_thinnest(d) == ref_procs.pick_thinnest(d)
    for key in list(range(64)) + ["cmu440", "tenant"]:
        assert procs.resolve_owner(d, key) == ref_procs.resolve_owner(d, key)


def test_spools_cross_ingest_and_drop_fenced_lines(tmp_path):
    d = str(tmp_path / "state")
    os.makedirs(d)
    port = procs.SpoolResultCache(64, d, 0, "p0")
    ref = ref_procs.SpoolResultCache(64, d, 1, "r1")
    gone_port = procs.SpoolResultCache(64, d, 2, "dead2")
    gone_ref = ref_procs.SpoolResultCache(64, d, 3, "dead3")
    entries = {}
    for i, cache in enumerate((port, ref, gone_port, gone_ref)):
        for j in range(3):
            key = (f"m{i}", 0, 100 * j + i, 0)
            entries[key] = (1000 * i + j, 7 * j)
            cache.put(key, entries[key])
    # A torn tail line (a writer mid-append) is left for the next pass.
    with open(os.path.join(d, "cache_1_r1.spool"), "a") as fh:
        fh.write('{"rid": 1, "inc": "r1", "key": ["torn"')
    m = health.Membership()
    for rid, inc in ((0, "p0"), (1, "r1"), (2, "dead2"), (3, "dead3")):
        m.admit(health.Beat(rid=rid, incarnation=inc, seq=1))
    m.declare_dead(2)
    m.declare_dead(3)
    ref_m = ref_procs.read_membership  # the JAX Membership from the file
    procs.write_json_atomic(procs.membership_path(d), m.to_dict())
    assert port.ingest(m) == ref.ingest(ref_m(d)) == 3
    assert port.dropped_fenced == ref.dropped_fenced == 6
    mine = {k: v for k, v in entries.items() if k[0] in ("m0", "m1")}
    assert dict(port._d) == dict(ref._d) == mine
    assert port.ingest(m) == ref.ingest(ref_m(d)) == 0
    # The fenced incarnations' spools are litter: both GCs remove them.
    d2 = str(tmp_path / "copy")
    shutil.copytree(d, d2)
    assert procs.gc_fenced_spools(d, m) == \
        ref_procs.gc_fenced_spools(d2, ref_m(d2)) == 2
    assert sorted(os.listdir(d)) == sorted(os.listdir(d2))


def test_owner_gone_table_equals_jax():
    m = health.Membership()
    for rid in (0, 1):
        m.admit(health.Beat(rid=rid, incarnation=f"i{rid}", seq=1))
    m.declare_dead(1)
    m.admit(health.Beat(rid=1, incarnation="j1", seq=1))
    ref_m = ref_procs.Membership.from_dict(m.to_dict())
    for mem, rm in ((None, None), (m, ref_m)):
        for rid, inc in ((0, "i0"), (1, "i1"), (1, "j1"), (5, "x")):
            assert procs.MinerAgent.owner_gone(mem, rid, inc) == \
                ref_procs.MinerAgent.owner_gone(rm, rid, inc)


def test_fake_searcher_equals_jax():
    """The ``--fake`` agents' made-up answers, the same function of
    (data, lower) in both packages (within one process: ``hash`` of a
    string is seeded per process)."""
    for data, lower, upper in (("x", 0, 9), ("cmu440", 2 ** 40, 2 ** 41),
                               ("", 7, 7)):
        assert procs._InstantSearcher(data).search(lower, upper) == \
            ref_procs._InstantSearcher(data).search(lower, upper)


@pytest.mark.parametrize("env", [
    {}, {"RETRY_ATTEMPTS": "0", "RETRY_TIMEOUT_S": "2.5",
         "RETRY_BACKOFF_S": "0.1", "RETRY_BACKOFF_CAP_S": "1"},
    {"RETRY_ATTEMPTS": "7", "RETRY_TIMEOUT_S": "junk"}])
def test_retry_reader_equals_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(f"DBMT_{k}", v)
        monkeypatch.setenv(f"DBM_{k}", v)
    assert vars(config.retry_from_env()) == \
        vars(ref_config.retry_from_env())


# ------------------------------------------------------ the retry plane


def test_submit_with_retry_survives_a_server_restart():
    params = fast_params(epoch_ms=50, limit=5)

    async def serve(port):
        server = await new_async_server(port, params)
        sched = Scheduler(server, verify=config.VerifyParams(audit_p=0.0))
        task = asyncio.ensure_future(sched.run())
        worker = MinerWorker(f"127.0.0.1:{server.port}", params=params,
                             searcher_factory=cpu_factory(delay=0.5))
        await worker.join()
        wtask = asyncio.ensure_future(worker.run())
        return server, [task, wtask], worker

    async def stop(server, tasks, worker):
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        await worker.close()
        await server.close()

    async def scenario():
        server, tasks, worker = await serve(0)
        port = server.port
        job = asyncio.ensure_future(submit_with_retry(
            f"127.0.0.1:{port}", "restart", 4_000, params=params,
            retry=config.RetryParams(attempts=6, timeout_s=1.5,
                                     backoff_s=0.2)))
        await asyncio.sleep(0.2)           # in flight on the first server
        await stop(server, tasks, worker)
        await asyncio.sleep(0.3)
        server, tasks, worker = await serve(port)
        try:
            got = await asyncio.wait_for(job, 30)
        finally:
            await stop(server, tasks, worker)
        return got

    got = asyncio.run(scenario())
    assert got == (*scan_min("restart", 0, 4_001), False)


def test_client_cli_takes_the_retry_plane_for_a_ring(tmp_path, monkeypatch,
                                                     capsys):
    """A ``ring:`` target goes through ``submit_with_retry``: with no
    membership published every attempt backs off, and the CLI prints the
    reference's ``Disconnected``; the retry counters count it."""
    from distributed_bitcoinminer_tpu_torch.apps import client
    from distributed_bitcoinminer_tpu_torch.utils.metrics import registry
    monkeypatch.setenv("DBMT_RETRY_BACKOFF_S", "0.01")
    monkeypatch.setenv("DBMT_RETRY_ATTEMPTS", "3")
    counters = registry().snapshot()["counters"]
    before = (counters["client.retry_attempts"],
              counters["client.retry_outcomes{outcome=exhausted}"])
    assert client.main(["client", f"ring:{tmp_path}", "cmu440", "99"]) == 0
    assert capsys.readouterr().out.strip() == "Disconnected"
    counters = registry().snapshot()["counters"]
    assert (counters["client.retry_attempts"],
            counters["client.retry_outcomes{outcome=exhausted}"]) == \
        (before[0] + 3, before[1] + 1)


# ----------------------------------------------------- a live topology


def _dbmtop(statedir):
    out = subprocess.run(
        [sys.executable, "-m", "distributed_bitcoinminer_tpu_torch.tools."
         "dbmtop", "--once", "--json", statedir], capture_output=True,
        text=True, timeout=60, cwd=REPO)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


def _blob_counter(statedir, role, rid, name):
    d = procs.read_json(os.path.join(statedir, f"metrics_{role}_{rid}.json"))
    return ((d or {}).get("snapshot", {}).get("counters", {})).get(name, 0)


def _started(statedir, rid):
    """Requests replica ``rid`` has put in flight (its queue waits)."""
    d = procs.read_json(os.path.join(statedir, f"metrics_replica_{rid}.json"))
    hist = (d or {}).get("snapshot", {}).get("histograms", {}).get(
        "sched.queue_wait_s") or {}
    return hist.get("count", 0)


def test_proc_cluster_ring_client_survives_its_owners_kill(tmp_path):
    statedir = str(tmp_path / "state")
    env = {"DBMT_COMPUTE": "host", "DBMT_HEALTH_BEAT_S": "0.2",
           "DBMT_EPOCH_MILLIS": "200", "DBMT_EPOCH_LIMIT": "5",
           "DBMT_CACHE": "0"}
    cluster = procs.ProcCluster(statedir, replicas=2, miners=1, gateways=1,
                                children=2, env=env,
                                logdir=str(tmp_path / "logs"))
    params = fast_params(epoch_ms=200, limit=5)
    data, max_nonce = "cmu440", (1 << 26) - 1

    async def scenario():
        m = await cluster.wait_live(2, timeout_s=30, miners=2)
        before = _dbmtop(statedir)
        owner, _ = procs.resolve_owner(statedir, data)
        started0 = _started(statedir, owner)
        job = asyncio.ensure_future(submit_with_retry(
            f"ring:{statedir}", data, max_nonce, params=params,
            retry=config.RetryParams(attempts=8, timeout_s=20,
                                     backoff_s=0.2)))
        deadline = time.monotonic() + 20
        while _started(statedir, owner) <= started0:
            assert time.monotonic() < deadline, "never granted"
            assert not job.done(), "answered before the kill"
            await asyncio.sleep(0.05)
        assert cluster.kill_replica(owner)
        t_kill = time.monotonic()
        got = await asyncio.wait_for(job, 60)
        t_reply = time.monotonic() - t_kill
        after_m = cluster.membership()
        after = _dbmtop(statedir)
        return m, before, owner, got, t_reply, after_m, after

    cluster.start()
    try:
        m, before, owner, got, t_reply, after_m, after = \
            asyncio.run(scenario())
    finally:
        cluster.close()
    # The pure-Python oracle takes minutes over 2^26 nonces: the JAX
    # package's native scan (held to it in tests/test_native.py) stands in.
    assert got == (*ref_native.scan_min_native(data, 0, max_nonce + 1),
                   False)
    # The router's missed-beat detection fenced the owner (no test hook).
    assert after_m.epoch > m.epoch and after_m.is_fenced(
        owner, m.live[owner]["incarnation"])
    assert list(after_m.live) == [1 - owner]
    roles = sorted(p["role"] for p in before["procs"])
    assert roles == ["gateway", "miner", "replica", "replica", "router"]
    assert all(p["status"] == "fresh" for p in before["procs"])
    assert [s["objective"] for s in before["slo"]] == \
        ["reply_availability", "queue_wait_p99", "shed_rate"]
    dead = next(p for p in after["procs"] if p["proc"] == f"replica{owner}")
    assert dead["status"] in ("fenced", "stale")
    assert f"replica{owner}" not in json.dumps(after["cluster"]["gauges"])
    # Exactly once: the survivor answered the one retried request.
    assert _blob_counter(statedir, "replica", 1 - owner,
                         "sched.results_sent") == 1
