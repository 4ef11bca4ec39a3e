"""The port's socket-free transport (``lspnet/detnet.py``) and the
scheduler's batched receive, against the JAX package's.

One scripted exchange (connect, writes both ways, an empty read, a peer's
close, a shed's ``close_conn``, a write to the dead conn, a new conn)
runs through both packages' ``DetServer``: the conn ids, the ``sent_to``
and ``sent`` logs, the delivery log and every item read are equal. Then
several servers on one loop, and ``recv_batch`` 1 against 64: the port's
``Scheduler`` and ``ReplicaSet`` and the JAX ``Scheduler`` give every
tenant the same replies, each the hashlib oracle's.
"""

import asyncio

import pytest

from distributed_bitcoinminer_tpu.apps.scheduler import \
    Scheduler as RefScheduler
from distributed_bitcoinminer_tpu.bitcoin import message as ref_message
from distributed_bitcoinminer_tpu.lspnet import detnet as ref_detnet
from distributed_bitcoinminer_tpu.utils import config as ref_config
from distributed_bitcoinminer_tpu_torch.apps.replicas import ReplicaSet
from distributed_bitcoinminer_tpu_torch.apps.scheduler import Scheduler
from distributed_bitcoinminer_tpu_torch.bitcoin import message
from distributed_bitcoinminer_tpu_torch.bitcoin.hash import scan_min
from distributed_bitcoinminer_tpu_torch.lsp.errors import LspError
from distributed_bitcoinminer_tpu_torch.lspnet import detnet
from distributed_bitcoinminer_tpu_torch.utils import config


def _item(item):
    """A read item with its exception as (class name, text)."""
    cid, body = item
    if isinstance(body, Exception):
        return cid, (type(body).__name__, str(body))
    return cid, body


async def _read_exc(chan):
    try:
        return await asyncio.wait_for(chan.read(), 1.0)
    except Exception as exc:           # noqa: BLE001 — compared by name
        return (type(exc).__name__, str(exc))


def _script(mod):
    async def run():
        s = mod.DetServer()
        a, b = s.connect(), s.connect()
        a.write(b"hello")
        b.write(b"x" * 100)
        a.write(b"again")
        s.write(1, b"back")
        s.write(2, b"yo")
        s.write(1, b"twice")
        reads = [_item(await s.read()) for _ in range(3)]
        empty = s.read_nowait()
        got = [await a.read(), await b.read(), await a.read()]
        await a.close()                     # the peer closes: a drop
        reads.append(_item(await s.read()))
        s.close_conn(2)                     # a shed: no drop event
        dead = await _read_exc(b)
        try:
            s.write(2, b"z")
            late = None
        except Exception as exc:       # noqa: BLE001
            late = type(exc).__name__
        c = s.connect()
        c.write(b"after")
        reads.append(_item(s.read_nowait()))
        return {"ids": [a.conn_id, b.conn_id, c.conn_id], "reads": reads,
                "empty": empty, "got": got, "dead": dead, "late": late,
                "sent_to": [s.sent_to(i) for i in (1, 2, 3)],
                "sent": [a.sent, b.sent, c.sent], "read_log": s._read_log,
                "writes": s.writes, "after": s.read_nowait()}
    return asyncio.run(run())


def test_scripted_exchange_equals_the_jax_detnet():
    port = _script(detnet)
    assert port == _script(ref_detnet)
    assert port["ids"] == [1, 2, 3]
    assert port["reads"][3] == (1, ("ConnectionClosed", "conn 1 dropped"))
    assert port["reads"][4] == (3, b"after")
    assert port["dead"][0] == "ConnectionClosed"
    assert port["late"] == "ConnectionClosed" and port["empty"] is None


def test_record_false_keeps_no_logs_and_delivers_the_same():
    async def run():
        s = detnet.DetServer(record=False)
        a = s.connect()
        a.write(b"p")
        s.write(1, b"q")
        return await s.read(), await a.read(), s.writes, s._read_log, a.sent
    assert asyncio.run(run()) == ((1, b"p"), b"q", [], [], [])


def test_several_servers_share_one_loop():
    async def run():
        servers = [detnet.DetServer() for _ in range(3)]
        chans = [[s.connect() for _ in range(2)] for s in servers]
        for k, (s, pair) in enumerate(zip(servers, chans)):
            for j, ch in enumerate(pair):
                ch.write(f"s{k} c{j}".encode())
                s.write(ch.conn_id, f"to s{k} c{j}".encode())
        reads = [[await s.read() for _ in range(2)] for s in servers]
        got = [[await ch.read() for ch in pair] for pair in chans]
        return reads, got
    reads, got = asyncio.run(run())
    for k in range(3):
        assert reads[k] == [(1, f"s{k} c0".encode()),
                            (2, f"s{k} c1".encode())]
        assert got[k] == [f"to s{k} c0".encode(), f"to s{k} c1".encode()]


async def _settle():
    for _ in range(10):
        await asyncio.sleep(0)


def _drive(kind: str, recv_batch: int):
    """Six tenants' requests through a scheduler on detnet with two
    miners answering from the hashlib oracle; each tenant's replies."""
    ref = kind == "jax"
    msg = ref_message if ref else message
    net = ref_detnet if ref else detnet

    async def run():
        server = net.DetServer()
        if ref:
            coord = RefScheduler(
                server, lease=ref_config.LeaseParams(queue_alarm_s=0.0),
                qos=ref_config.QosParams(enabled=False),
                cache=ref_config.CacheParams(enabled=False),
                adapt=ref_config.AdaptParams(enabled=False),
                recv_batch=recv_batch)
        else:
            kw = dict(lease=config.LeaseParams(queue_alarm_s=0.0),
                      qos=config.QosParams(enabled=False),
                      cache=config.CacheParams(enabled=False),
                      adapt=config.AdaptParams(enabled=False),
                      recv_batch=recv_batch)
            coord = ReplicaSet(server, 2, **kw) if kind == "replicas" \
                else Scheduler(server, **kw)
        tasks = [asyncio.create_task(coord.run())]

        async def miner(chan):
            chan.write(msg.new_join().to_json())
            while True:
                m = msg.Message.from_json(await chan.read())
                if m.type == msg.MsgType.REQUEST:
                    h, n = scan_min(m.data, m.lower, m.upper)
                    chan.write(msg.new_result(h, n).to_json())

        for _ in range(2):
            tasks.append(asyncio.create_task(miner(server.connect())))
        await _settle()
        chans = [server.connect() for _ in range(6)]
        for i, chan in enumerate(chans):
            for j in range(2):
                chan.write(msg.new_request(f"rb{i}.{j}", 0,
                                           60 + 7 * i + j).to_json())
        out = []
        for chan in chans:
            mine = []
            while len(mine) < 2:
                m = msg.Message.from_json(
                    await asyncio.wait_for(chan.read(), 10))
                if m.type == msg.MsgType.RESULT:
                    mine.append((m.hash, m.nonce))
            out.append(mine)
        for t in tasks:
            t.cancel()
        return out
    return asyncio.run(run())


def test_recv_batch_one_and_64_answer_alike_and_as_the_jax_scheduler():
    want = [[scan_min(f"rb{i}.{j}", 0, 61 + 7 * i + j) for j in range(2)]
            for i in range(6)]
    assert _drive("jax", 64) == want
    for kind in ("scheduler", "replicas"):
        for batch in (1, 64):
            assert _drive(kind, batch) == want, (kind, batch)


@pytest.mark.parametrize("value, want", [(None, 64), ("1", 1), ("16", 16),
                                         ("0", 1), ("-3", 1),
                                         ("junk", 64)])
def test_recv_batch_reader_clamps_like_the_jax_one(monkeypatch, value,
                                                   want):
    for name in ("DBMT_RECV_BATCH", "DBM_RECV_BATCH"):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    assert config.recv_batch_from_env() == want
    server = detnet.DetServer()
    port = Scheduler(server)
    ref = RefScheduler(ref_detnet.DetServer())
    assert port._recv_batch == ref._recv_batch == want
    assert ReplicaSet(server, 2)._recv_batch == want
    assert Scheduler(server, recv_batch=0)._recv_batch == 1
    with pytest.raises(LspError):
        server.write(99, b"nobody")
