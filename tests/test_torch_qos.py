"""The port's QoS pump against the JAX package's, grant for grant.

The port's scheduler and the JAX package's ``Scheduler`` are driven
through the same scripted sequence of joins, requests, Results and client
drops over a fake server that records every write, with the pool's
throughput pinned. The JAX side runs its eager pump (``lazy=False``, the
counterpart the port follows) with the features the port leaves out
switched off (striping, audits, adapt, the result cache). Compared: every
message each scheduler writes — the Requests each miner is sent, so the
chunk bounds, and the Results each client gets — and each miner's
coalescing grouping. The scenarios mirror the JAX package's
``tests/test_batch.py`` window tests; a seeded random drive covers the
rest. Plus the DRR plane and the tenant queue on their own.
"""

import numpy as np
import pytest

from distributed_bitcoinminer_tpu.apps.qos import QosPlane as RefQosPlane
from distributed_bitcoinminer_tpu.apps.scheduler import \
    Scheduler as RefScheduler
from distributed_bitcoinminer_tpu.utils.config import (
    AdaptParams, CacheParams, LeaseParams, StripeParams, VerifyParams)
from distributed_bitcoinminer_tpu.utils.config import \
    CoalesceParams as RefCoalesceParams
from distributed_bitcoinminer_tpu.utils.config import \
    QosParams as RefQosParams
from distributed_bitcoinminer_tpu.utils.metrics import Registry
from distributed_bitcoinminer_tpu_torch.apps.qos import QosPlane
from distributed_bitcoinminer_tpu_torch.apps.scheduler import Request, \
    Scheduler
from distributed_bitcoinminer_tpu_torch.apps.tenant_plane import TenantPlane
from distributed_bitcoinminer_tpu_torch.utils.metrics import \
    Registry as PortRegistry
from distributed_bitcoinminer_tpu_torch.bitcoin.hash import (hash_op,
                                                             scan_until)
from distributed_bitcoinminer_tpu_torch.bitcoin.message import (
    Message, new_request, new_result)
from distributed_bitcoinminer_tpu_torch.utils.config import \
    AdaptParams as PortAdaptParams
from distributed_bitcoinminer_tpu_torch.utils.config import \
    CacheParams as PortCacheParams
from distributed_bitcoinminer_tpu_torch.utils.config import \
    CoalesceParams, QosParams
from distributed_bitcoinminer_tpu_torch.utils.config import \
    StripeParams as PortStripeParams
from distributed_bitcoinminer_tpu_torch.utils.config import \
    VerifyParams as PortVerifyParams

MINER_A, MINER_B, MINER_C = 101, 102, 103
TEN_X, TEN_Y, TEN_Z = 1, 2, 3


class FakeServer:
    """Records writes as wire tuples; the scheduler never reads it."""

    def __init__(self):
        self.writes = []

    def write(self, conn_id, payload):
        m = Message.from_json(payload)
        self.writes.append((conn_id, int(m.type), m.data, m.lower, m.upper,
                            m.hash, m.nonce, m.target))

    def close_conn(self, conn_id):
        pass


class Pair:
    """The port's scheduler and the JAX package's, fed the same events."""

    def __init__(self, qos=None, coalesce=True, pin=100.0, **qos_kw):
        qos_kw.setdefault("wholesale_s", 0.5)
        qos_kw.setdefault("chunk_s", 1.0)
        qos_kw.setdefault("depth", 2)
        lanes = 4
        self.port_server, self.ref_server = FakeServer(), FakeServer()
        # Both sides pinned alike: the eager pump, no striping, no cache.
        self.port = Scheduler(
            self.port_server, qos=QosParams(enabled=qos is not False,
                                             lazy=False, **qos_kw),
            coalesce=CoalesceParams(enabled=coalesce, lanes=lanes),
            verify=PortVerifyParams(audit_p=0.0),
            stripe=PortStripeParams(enabled=False),
            cache=PortCacheParams(enabled=False),
            adapt=PortAdaptParams(enabled=False))
        self.ref = RefScheduler(
            self.ref_server, lease=LeaseParams(),
            qos=RefQosParams(enabled=qos is not False, lazy=False, **qos_kw),
            coalesce=RefCoalesceParams(enabled=coalesce, lanes=lanes),
            stripe=StripeParams(enabled=False),
            adapt=AdaptParams(enabled=False),
            cache=CacheParams(enabled=False),
            verify=VerifyParams(audit_p=0.0))
        if pin:
            self.port.miner_plane.pool_rate = pin
            self.port.miner_plane.observe_result = lambda m, c: None
            self.ref._pool_rate = pin
            self.ref._observe_result = lambda m, c: None
            # The JAX plane calls its own method, not the scheduler's
            # shim: pin it too, so neither side samples a rate.
            self.ref.miner_plane.observe_result = lambda m, c: None

    def both(self, fn):
        fn(self.port)
        fn(self.ref)

    def join(self, conn):
        self.both(lambda s: s._on_join(conn))

    def request(self, conn, data, max_nonce, target=0):
        self.both(lambda s: s._on_request(
            conn, new_request(data, 0, max_nonce, target)))

    def drop(self, conn):
        self.both(lambda s: s._on_drop(conn))

    def answer(self, miner, lie=False, scan=False):
        """Answer the miner's oldest pending chunk with a true claim: the
        hash of its lower bound (the target echoed), or with ``scan`` the
        chunk's own answer (``scan_until`` over it); with ``lie``, that
        claim's hash with its low bit flipped."""
        c = self.port.miner_plane.find_miner(miner).pending[0]
        h, nonce = (scan_until(c.data, c.lower, c.upper, c.target)[:2]
                    if scan else (hash_op(c.data, c.lower), c.lower))
        msg = new_result(h ^ int(lie), nonce, c.target)
        self.both(lambda s: s._on_result(miner, msg))

    def busy(self):
        return [m.conn_id for m in self.port.miners if m.pending]

    def groups(self, sched):
        """Per miner, its pending chunks' ``(data, lower)`` partitioned by
        coalesce id (None ids stand alone)."""
        out = {}
        for m in sched.miners:
            parts = {}
            for c in m.pending:
                key = c.coalesce_id if c.coalesce_id is not None \
                    else ("solo", c.job_id, c.idx)
                parts.setdefault(key, []).append((c.data, c.lower, c.upper,
                                                  c.cancelled))
            out[m.conn_id] = sorted(parts.values())
        return out

    def check(self):
        assert self.port_server.writes == self.ref_server.writes
        assert self.groups(self.port) == self.groups(self.ref)
        for name in ("results_sent", "qos_grants", "qos_window_grants"):
            assert self.port.stats[name] == self.ref.stats[name], name
        assert list(self.port.inflight) == list(self.ref.inflight)


def _mice_chunks(sched):
    return [c for m in sched.miners for c in m.pending
            if c.data.startswith("mouse")]


def test_window_stacks_mice_from_many_tenants_on_one_miner():
    """With the pool saturated by a chunked elephant, mice of two other
    tenants are granted into ONE miner's window in one pump pass: one
    shared coalesce id, one live slot, DRR debited per chunk."""
    p = Pair()
    p.join(MINER_A)
    p.join(MINER_B)
    p.request(TEN_X, "elephant", 9_999)
    assert p.port.current.qos_mode == "chunked"
    p.request(TEN_Y, "mouse y", 9)
    p.request(TEN_Z, "mouse z", 9)
    assert len(p.port.tenant_plane) == 2
    p.answer(MINER_A)
    p.check()
    assert p.port.stats["qos_window_grants"] >= 1
    mice = _mice_chunks(p.port)
    assert len(mice) == 2 and len({c.coalesce_id for c in mice}) == 1
    assert None not in {c.coalesce_id for c in mice}
    (conn,) = {m.conn_id for m in p.port.miners for c in m.pending
               if c in mice}
    wm = p.port.miner_plane.find_miner(conn)
    live_raw = sum(1 for c in wm.pending if not c.cancelled)
    assert p.port.miner_plane.miner_live(wm) == live_raw - 1
    assert p.port.qos_plane.tenants[TEN_Y].granted_chunks == 1
    assert p.port.qos_plane.tenants[TEN_Z].granted_chunks == 1


def test_window_never_stacks_one_requests_chunks():
    p = Pair(chunk_s=0.1)
    p.join(MINER_A)
    p.join(MINER_B)
    p.request(TEN_X, "self", 999)
    assert p.port.current.qos_mode == "chunked"
    p.check()
    assert p.port.stats["qos_window_grants"] == 0
    assert max(sum(1 for c in m.pending if not c.cancelled)
               for m in p.port.miners) <= 2


def test_coalescing_off_opens_no_window():
    p = Pair(coalesce=False)
    p.join(MINER_A)
    p.join(MINER_B)
    p.request(TEN_X, "elephant", 9_999)
    p.request(TEN_Y, "mouse y", 9)
    p.request(TEN_Z, "mouse z", 9)
    p.answer(MINER_A)
    p.check()
    assert p.port.stats["qos_window_grants"] == 0
    assert all(c.coalesce_id is None
               for m in p.port.miners for c in m.pending)
    for m in p.port.miners:
        assert p.port.miner_plane.miner_live(m) == \
            sum(1 for c in m.pending if not c.cancelled)


@pytest.mark.parametrize("pin", [None, 1e9], ids=["cold", "warm"])
def test_single_tenant_qos_grants_equal_stock_fifo(pin):
    """One tenant's requests with QoS on give the stock FIFO's writes:
    on a cold pool every request is wholesale, and on a warm one so is
    every request that fits ``wholesale_s``."""
    runs = []
    for qos in (True, False):
        p = Pair(qos=qos, pin=pin)
        for m in (MINER_A, MINER_B, MINER_C):
            p.join(m)
        for j, mx in enumerate((5_000, 1, 0, 77_777, 3)):
            p.request(TEN_X, f"fifo {j}", mx)
        p.request(TEN_X, "fifo target", 40_000, 1 << 62)
        while p.busy():
            p.answer(p.busy()[0])
        p.check()
        runs.append(p.port_server.writes)
    assert runs[0] == runs[1]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_drive_equals_jax(seed):
    """Seeded traffic: tenants send elephants, mice and a difficulty
    request, miners answer in a random order, a client drops mid-way;
    after every event both schedulers have written the same messages
    and hold the same windows."""
    rng = np.random.default_rng(seed)
    p = Pair(pin=float(rng.choice([50.0, 100.0, 400.0])),
             depth=int(rng.integers(1, 4)))
    for m in (MINER_A, MINER_B, MINER_C)[:int(rng.integers(2, 4))]:
        p.join(m)
    tenants = [TEN_X, TEN_Y, TEN_Z, 4, 5]
    dropped = False
    for step in range(60):
        r = rng.random()
        if r < 0.5:
            t = int(rng.choice(tenants))
            big = rng.random() < 0.2
            mx = int(rng.integers(2_000, 20_000) if big
                     else rng.integers(0, 60))
            target = 1 << 61 if rng.random() < 0.1 else 0
            p.request(t, f"{'elephant' if big else 'mouse'} {t}.{step}",
                      mx, target)
        elif r < 0.95 and p.busy():
            busy = p.busy()
            p.answer(busy[int(rng.integers(0, len(busy)))])
        elif not dropped and step > 20:
            dropped = True
            p.drop(int(rng.choice(tenants)))
        p.check()
    while p.busy():
        p.answer(p.busy()[0])
        p.check()
    assert p.port.stats["qos_window_grants"] > 0


@pytest.mark.parametrize("case", ["takeover", "parked", "target"])
def test_false_claim_pumps_like_jax(case):
    """A miner's false claim while ungranted chunks are still queued: the
    range goes to another miner (or is parked when there is none), and
    the freed slot is granted at once, as the JAX ``Scheduler._claim_ok``
    does with its closing pump. Every write equals the reference's after
    every event, and the client's Result is the ``bitcoin.hash``
    oracle's."""
    p = Pair(chunk_s=0.1)
    miners = (MINER_A,) if case == "parked" else (MINER_A, MINER_B)
    for m in miners:
        p.join(m)
    target = 1 << 60 if case == "target" else 0
    p.request(TEN_X, "elephant", 9_999, target)
    assert p.port.current.qos_mode == "chunked"
    p.check()
    p.answer(MINER_A, lie=True, scan=True)
    assert p.port.stats["claims_failed"] == 1
    p.check()
    while p.busy():
        p.answer(p.busy()[0], scan=True)
        p.check()
    (result,) = [w for w in p.port_server.writes if w[0] == TEN_X]
    h, nonce, found = scan_until("elephant", 0, 9_999, target)
    assert result[5:7] == (h, nonce)
    assert found == (target != 0 and h < target)


# -------------------------------------------------------- the DRR plane

def _drive(plane, weights, grants, cost):
    for t, w in weights.items():
        plane.tenant(t, w)
    picks = []
    for i in range(grants):
        t = plane.pick({t: cost + (i % 3) * t for t in weights})
        plane.on_grant(t, cost)
        plane.on_chunk_answered(t)
        picks.append(t)
    return picks


def test_drr_picks_equal_jax_and_share_follows_weight():
    weights = {TEN_X: 1.0, TEN_Y: 2.0, TEN_Z: 4.0}
    picks = _drive(QosPlane(PortRegistry()), weights, 700, 100)
    assert picks == _drive(RefQosPlane(Registry()), weights, 700, 100)
    plane = QosPlane(PortRegistry())
    _drive(plane, weights, 700, 100)
    for t, w in weights.items():
        assert plane.grant_share(t) == pytest.approx(w / 7, abs=0.05)


def test_drr_sync_forget_release():
    plane = QosPlane(PortRegistry())
    plane.tenant(TEN_X).deficit = 50.0
    plane.sync_backlog([TEN_X, TEN_Y])
    assert list(plane.ring) == [TEN_X, TEN_Y]
    plane.sync_backlog([TEN_Y])
    assert list(plane.ring) == [TEN_Y] and plane.tenants[TEN_X].deficit == 0
    plane.on_grant(TEN_Y, 10)
    plane.on_grant(TEN_Y, 10)
    plane.release(TEN_Y, 5)
    assert plane.tenants[TEN_Y].inflight == 0
    plane.forget(TEN_Y)
    assert TEN_Y not in plane.tenants and not plane.ring
    assert plane.pick({}) is None


def test_tenant_queue_index():
    q = TenantPlane(PortRegistry(), QosParams(), lambda name, n=1: None)
    reqs = [Request(conn_id=t, data=f"r{i}", lower=0, upper=i)
            for i, t in enumerate([TEN_X, TEN_Y, TEN_X, TEN_Z, TEN_Y])]
    for r in reqs:
        q.enqueue(r)
    assert q.backlog_tenants() == [TEN_X, TEN_Y, TEN_Z]
    assert [(t, r.data) for t, r in q.tenant_heads()] == \
        [(TEN_X, "r0"), (TEN_Y, "r1"), (TEN_Z, "r3")]
    q.dequeue(reqs[2])
    assert q.pop_head() is reqs[0]
    assert [r.data for r in q.purge_tenant(TEN_Y)] == ["r1", "r4"]
    assert q.requests() == [reqs[3]] and len(q) == 1
    assert q.purge_tenant(TEN_Y) == []
