"""The port's lease plane against the JAX package's ``Scheduler``, in lockstep.

The port's scheduler and the JAX one are driven through the same events
(joins, requests, Results, drops, clock steps and sweeps) over the fake
server of ``tests/test_torch_qos.py``, with one fake clock read by both
packages' scheduler, miner plane and tenant plane. The JAX side runs with
the features the port leaves out switched off (striping, adapt, the
result cache; the eager QoS pump). After every event both have written
the same messages, hold the same counters, and hold the same miners:
pending chunks with their deadlines and lease flags, blown streaks,
quarantine, trust and rate EWMAs. Results are honest (the ``bitcoin.hash``
oracle over the chunk), unless a case says otherwise. The cases mirror
``tests/test_scheduler_recovery.py``'s lease tests; a seeded random
drive covers the rest. Plus ``lease_from_env`` against the JAX reader.
"""

import random
import types

import numpy as np
import pytest

from distributed_bitcoinminer_tpu.apps import miner_plane as ref_mp_mod
from distributed_bitcoinminer_tpu.apps import scheduler as ref_sched_mod
from distributed_bitcoinminer_tpu.apps import tenant_plane as ref_tp_mod
from distributed_bitcoinminer_tpu.apps.scheduler import \
    Scheduler as RefScheduler
from distributed_bitcoinminer_tpu.bitcoin.hash import scan_min
from distributed_bitcoinminer_tpu.utils import config as ref_config
from distributed_bitcoinminer_tpu.utils.config import (AdaptParams,
                                                       CacheParams,
                                                       StripeParams)
from distributed_bitcoinminer_tpu_torch.apps import miner_plane as mp_mod
from distributed_bitcoinminer_tpu_torch.apps import scheduler as sched_mod
from distributed_bitcoinminer_tpu_torch.apps import tenant_plane as tp_mod
from distributed_bitcoinminer_tpu_torch.apps.miner_plane import Chunk
from distributed_bitcoinminer_tpu_torch.apps.scheduler import (STAT_COUNTERS,
                                                               Scheduler)
from distributed_bitcoinminer_tpu_torch.bitcoin.hash import scan_until
from distributed_bitcoinminer_tpu_torch.bitcoin.message import (new_request,
                                                                new_result)
from distributed_bitcoinminer_tpu_torch.utils import config
from tests.test_torch_qos import FakeServer

MINER_A, MINER_B, MINER_C = 101, 102, 103
CLIENT_X, CLIENT_Y = 1, 2
T0 = 1000.0


class Clock:
    """``time.monotonic`` for both packages' planes, stepped by hand."""

    def __init__(self):
        self.t = T0

    def monotonic(self):
        return self.t

    def step(self, dt):
        self.t += dt


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    fake = types.SimpleNamespace(monotonic=c.monotonic)
    for mod in (sched_mod, mp_mod, tp_mod, ref_sched_mod, ref_mp_mod,
                ref_tp_mod):
        monkeypatch.setattr(mod, "time", fake)
    return c


def honest(chunk):
    """The chunk's own answer, ``Upper`` read inclusive: its arg-min, or
    with a target its first qualifying nonce."""
    return scan_until(chunk.data, chunk.lower, chunk.upper,
                      chunk.target)[:2]


class Pair:
    """The port's scheduler and the JAX package's, fed the same events.
    ``qos`` switches the QoS pump (off: the stock FIFO); ``verify`` is a
    dict of ``VerifyParams`` fields (default: audits off); the rest are
    ``LeaseParams`` fields."""

    def __init__(self, qos=False, verify=None, seed=7, qos_kw=None,
                 **lease_kw):
        verify = {"audit_p": 0.0, **(verify or {})}
        qos_kw = qos_kw or {}
        self.port_server, self.ref_server = FakeServer(), FakeServer()
        # Both sides pinned alike: the eager pump, no striping, no cache.
        self.port = Scheduler(
            self.port_server,
            qos=config.QosParams(enabled=qos, lazy=False, **qos_kw),
            coalesce=config.CoalesceParams(),
            lease=config.LeaseParams(**lease_kw),
            verify=config.VerifyParams(**verify),
            audit_rng=random.Random(seed),
            stripe=config.StripeParams(enabled=False),
            cache=config.CacheParams(enabled=False),
            adapt=config.AdaptParams(enabled=False))
        self.ref = RefScheduler(
            self.ref_server, lease=ref_config.LeaseParams(**lease_kw),
            qos=ref_config.QosParams(enabled=qos, lazy=False, **qos_kw),
            coalesce=ref_config.CoalesceParams(),
            stripe=StripeParams(enabled=False),
            adapt=AdaptParams(enabled=False),
            cache=CacheParams(enabled=False),
            verify=ref_config.VerifyParams(**verify),
            audit_rng=random.Random(seed))

    def both(self, fn):
        fn(self.port)
        fn(self.ref)
        self.check()

    def join(self, conn):
        self.both(lambda s: s._on_join(conn))

    def request(self, conn, data, max_nonce, target=0):
        self.both(lambda s: s._on_request(
            conn, new_request(data, 0, max_nonce, target)))

    def drop(self, conn):
        self.both(lambda s: s._on_drop(conn))

    def sweep(self):
        self.both(lambda s: s.sweep())

    def result(self, miner, h, nonce, target=0):
        msg = new_result(h, nonce, target)
        self.both(lambda s: s._on_result(miner, msg))

    def head(self, miner):
        return self.port.miner_plane.find_miner(miner).pending[0]

    def answer(self, miner, pair=None):
        """The miner answers its oldest chunk: honestly, or with
        ``pair(chunk)``'s ``(hash, nonce)``; the target echoed."""
        c = self.head(miner)
        h, nonce = (pair or honest)(c)
        self.result(miner, h, nonce, c.target)

    def set_miner(self, conn, **fields):
        """Set a miner's fields on both sides (a state a case starts
        from)."""
        for s in (self.port, self.ref):
            m = s.miner_plane.find_miner(conn)
            for k, v in fields.items():
                setattr(m, k, v)
        self.check()

    def busy(self):
        return [m.conn_id for m in self.port.miners if m.pending]

    def miner(self, conn, sched=None):
        return (sched or self.port).miner_plane.find_miner(conn)

    @staticmethod
    def miner_state(sched):
        return [(m.conn_id, m.quarantined, m.blown_streak, m.trust,
                 m.rate_ewma, m.available,
                 [(c.job_id, c.idx, c.lower, c.upper, c.target, c.cancelled,
                   c.lease_blown, c.reissued, c.lease_started, c.deadline,
                   c.coalesce_id is None)
                  for c in m.pending])
                for m in sched.miners]

    def check(self):
        assert self.port_server.writes == self.ref_server.writes
        for name in STAT_COUNTERS:
            assert self.port.stats[name] == self.ref.stats[name], name
        assert self.miner_state(self.port) == self.miner_state(self.ref)
        assert [(c.job_id, c.idx) for c in self.port.miner_plane.parked] == \
            [(c.job_id, c.idx) for c in self.ref.parked]
        assert list(self.port.inflight) == list(self.ref.inflight)
        assert self.port.miner_plane.pool_rate == self.ref._pool_rate
        assert sorted(self.port._audits) == sorted(self.ref._audits)

    def replies(self, conn):
        """``(hash, nonce)`` of every Result written to ``conn``."""
        return [(w[5], w[6]) for w in self.port_server.writes
                if w[0] == conn and w[1] == 2]

    def requests_to(self, conn):
        return [(w[3], w[4]) for w in self.port_server.writes
                if w[0] == conn and w[1] == 1]


def test_lease_expiry_reissues_and_quarantines(clock):
    """Expiry re-issues to an eligible miner once, a repeat offender is
    quarantined, gets nothing of the next request, and its late answer
    lifts the quarantine."""
    p = Pair(grace_s=30.0, quarantine_after=1, floor_s=0.1, factor=4.0)
    for m in (MINER_A, MINER_B, MINER_C):
        p.join(m)
    p.request(CLIENT_X, "slow pool", 299)
    stuck = p.head(MINER_A)
    p.answer(MINER_C)                    # C frees: an eligible takeover
    clock.step(30.5)                     # every lease past its grace
    p.sweep()
    assert p.port.stats["leases_blown"] == 2      # A's and B's chunks
    assert p.port.stats["reissues"] == 1          # only C was free
    assert stuck.lease_blown and stuck.reissued
    assert p.miner(MINER_A).quarantined and p.miner(MINER_B).quarantined
    p.sweep()                            # no double issue
    assert p.port.stats["reissues"] == 1
    p.answer(MINER_C)                    # the copy of A's chunk
    p.answer(MINER_B)                    # B's own; lifts its quarantine
    assert p.replies(CLIENT_X) == [scan_min("slow pool", 0, 300)]
    assert not p.miner(MINER_B).quarantined
    a = p.miner(MINER_A)
    assert a.available and a.quarantined
    p.request(CLIENT_Y, "without A", 199)
    assert p.port.current.num_chunks == 2
    assert len(p.requests_to(MINER_A)) == 1
    p.answer(MINER_A)                    # stale: lifts A's quarantine
    assert not a.quarantined and a.blown_streak == 0
    p.answer(MINER_B)
    p.answer(MINER_C)
    assert p.replies(CLIENT_Y) == [scan_min("without A", 0, 200)]


@pytest.mark.parametrize("qos", [False, True], ids=["fifo", "qos"])
def test_duplicate_result_in_flight_is_dropped_and_counted(clock, qos):
    p = Pair(qos=qos)
    for m in (MINER_A, MINER_B, MINER_C):
        p.join(m)
    p.request(CLIENT_X, "dup race", 299)
    stuck = p.head(MINER_A)
    p.answer(MINER_C)
    clock.step(31.0)
    p.sweep()                            # A's and B's leases blow
    assert p.port.stats["reissues"] == 1 and stuck.reissued
    p.answer(MINER_C)                    # the copy answers chunk 0
    assert p.port.current.answered[stuck.idx]
    p.answer(MINER_A)                    # the loser: a duplicate
    assert p.port.stats["dup_results"] == 1
    assert p.replies(CLIENT_X) == []
    p.answer(MINER_B)
    assert p.replies(CLIENT_X) == [scan_min("dup race", 0, 300)]


def test_desperation_dispatch_to_least_bad_quarantined(clock):
    p = Pair()
    p.join(MINER_A)
    p.join(MINER_B)
    p.set_miner(MINER_A, quarantined=True, blown_streak=5)
    p.set_miner(MINER_B, quarantined=True, blown_streak=2)
    p.request(CLIENT_X, "last resort", 99)
    assert p.port.stats["desperation_dispatch"] == 1
    assert p.port.stats["no_eligible_miner"] == 0
    assert p.requests_to(MINER_A) == [] and len(p.requests_to(MINER_B)) == 1
    p.answer(MINER_B)
    assert not p.miner(MINER_B).quarantined
    assert p.replies(CLIENT_X) == [scan_min("last resort", 0, 100)]


def test_desperation_on_the_qos_pump(clock):
    """The same last resort through the QoS pump's wholesale start."""
    p = Pair(qos=True)
    p.join(MINER_A)
    p.join(MINER_B)
    p.set_miner(MINER_A, quarantined=True, blown_streak=1)
    p.set_miner(MINER_B, quarantined=True, blown_streak=4)
    p.request(CLIENT_X, "last resort", 99)
    assert p.port.stats["desperation_dispatch"] == 1
    assert p.requests_to(MINER_B) == [] and len(p.requests_to(MINER_A)) == 1
    p.answer(MINER_A)
    assert p.replies(CLIENT_X) == [scan_min("last resort", 0, 100)]


def test_desperation_disabled_knob_keeps_starvation_latch(clock):
    p = Pair(desperation=False)
    p.join(MINER_A)
    p.set_miner(MINER_A, quarantined=True)
    p.request(CLIENT_X, "still starved", 99)
    assert p.port.stats["desperation_dispatch"] == 0
    assert p.port.stats["no_eligible_miner"] == 1
    assert p.port.current is None and len(p.port.tenant_plane) == 1


def test_desperation_requires_whole_pool_quarantined(clock):
    """One healthy but busy miner disables desperation."""
    p = Pair()
    p.join(MINER_A)
    p.join(MINER_B)
    p.set_miner(MINER_A, quarantined=True)
    for s in (p.port, p.ref):
        s.miner_plane.find_miner(MINER_B).pending.append(
            (Chunk if s is p.port else ref_mp_mod.Chunk)(
                job_id=999, data="busy", lower=0, upper=9))
    p.request(CLIENT_X, "patience", 99)
    assert p.port.stats["desperation_dispatch"] == 0
    assert p.port.current is None and len(p.port.tenant_plane) == 1
    assert p.requests_to(MINER_A) == []


def test_fifo_aware_lease_budgets_predecessors_then_tightens_at_head(clock):
    p = Pair()
    p.join(MINER_A)
    p.request(CLIENT_X, "doomed", 99)
    ahead = p.head(MINER_A)
    p.drop(CLIENT_X)                     # cancelled; A still grinding it
    clock.step(3.0)
    p.request(CLIENT_Y, "queued behind", 199)
    live = p.miner(MINER_A).pending[1]
    assert not live.lease_started and live.deadline > ahead.deadline
    clock.step(20.0)
    p.sweep()                            # inside the budget: no blow
    assert p.port.stats["leases_blown"] == 0
    p.answer(MINER_A)                    # stale pop: A reaches the chunk
    assert live.lease_started and live.deadline == clock.t + \
        p.port.miner_plane.lease_for(p.miner(MINER_A), live)
    p.answer(MINER_A)
    assert p.replies(CLIENT_Y) == [scan_min("queued behind", 0, 200)]


def test_fifo_aware_wedged_head_still_expires_deep_chunk(clock):
    p = Pair()
    p.join(MINER_A)
    p.request(CLIENT_X, "doomed", 99)
    p.drop(CLIENT_X)
    p.join(MINER_B)
    p.request(CLIENT_Y, "stuck deep", 199)
    live = next(c for c in p.miner(MINER_A).pending if not c.cancelled)
    p.answer(MINER_B)                    # B frees: an eligible takeover
    clock.step(61.0)                     # the whole budget elapsed
    p.sweep()
    assert p.port.stats["leases_blown"] == 1
    assert p.port.stats["leases_blown_spurious"] == 0
    assert p.port.stats["reissues"] == 1 and live.reissued
    p.answer(MINER_B)
    assert p.replies(CLIENT_Y) == [scan_min("stuck deep", 0, 200)]


def test_at_assignment_clock_blows_spuriously_and_is_counted(clock):
    p = Pair(fifo_aware=False)
    p.join(MINER_A)
    p.request(CLIENT_X, "doomed", 99)
    p.drop(CLIENT_X)
    p.request(CLIENT_Y, "queued behind", 199)
    live = p.miner(MINER_A).pending[1]
    assert live.lease_started
    clock.step(31.0)
    p.sweep()
    assert p.port.stats["leases_blown"] == 1
    assert p.port.stats["leases_blown_spurious"] == 1
    p.answer(MINER_A)
    p.answer(MINER_A)
    assert p.replies(CLIENT_Y) == [scan_min("queued behind", 0, 200)]


def test_leases_off_never_blow(clock):
    p = Pair(enabled=False)
    p.join(MINER_A)
    p.request(CLIENT_X, "no lease", 99)
    assert p.head(MINER_A).deadline == float("inf")
    clock.step(1e6)
    p.sweep()
    assert p.port.stats["leases_blown"] == 0


def test_queue_age_alarm_fires_once_per_bound_interval(clock):
    p = Pair(queue_alarm_s=5.0)
    p.request(CLIENT_X, "stalled", 99)   # no miners: stays queued
    p.sweep()
    assert p.port.stats["queue_alarms"] == 0
    clock.step(6.0)
    p.sweep()
    assert p.port.stats["queue_alarms"] == 1
    clock.step(1.0)
    p.sweep()                            # within the re-warn window
    assert p.port.stats["queue_alarms"] == 1
    clock.step(5.0)
    p.sweep()
    assert p.port.stats["queue_alarms"] == 2
    p.join(MINER_A)                      # dispatches; the queue empties
    p.sweep()
    assert p.port.stats["queue_alarms"] == 2
    assert p.port.stats["inflight_alarms"] == 0
    clock.step(5.0)
    p.sweep()                            # now it is the in-flight one
    assert p.port.stats["inflight_alarms"] == 1
    clock.step(4.0)
    p.sweep()
    assert p.port.stats["inflight_alarms"] == 1
    clock.step(1.0)
    p.sweep()
    assert p.port.stats["inflight_alarms"] == 2


def test_no_eligible_miner_latches_once_per_episode(clock):
    p = Pair()
    p.request(CLIENT_X, "starved", 99)   # no miners at all
    assert p.port.stats["no_eligible_miner"] == 1
    p.request(CLIENT_Y, "also starved", 99)
    assert p.port.stats["no_eligible_miner"] == 1
    p.join(MINER_A)
    p.answer(MINER_A)
    p.answer(MINER_A)
    assert p.replies(CLIENT_X) == [scan_min("starved", 0, 100)]
    assert p.replies(CLIENT_Y) == [scan_min("also starved", 0, 100)]
    p.set_miner(MINER_A, quarantined=True)
    for s in (p.port, p.ref):
        s.miner_plane.find_miner(MINER_A).pending.append(
            (Chunk if s is p.port else ref_mp_mod.Chunk)(
                job_id=999, data="wedged", lower=0, upper=9))
    p.request(CLIENT_X, "starved again", 99)
    assert p.port.stats["no_eligible_miner"] == 2
    assert p.port.stats["desperation_dispatch"] == 0


def test_rates_size_leases_per_miner(clock):
    """A warm miner's lease comes from its own EWMA, a cold miner's from
    the pool's; a blown or difficulty chunk gives no sample."""
    p = Pair(floor_s=0.5)
    p.join(MINER_A)
    p.request(CLIENT_X, "warm", 3_999)
    clock.step(1.0)
    p.answer(MINER_A)                    # 4,001 nonces in 1 s
    assert p.miner(MINER_A).rate_ewma == pytest.approx(4_001.0)
    p.join(MINER_B)
    p.request(CLIENT_X, "split", 7_999)
    for m in (MINER_A, MINER_B):
        c = p.head(m)
        assert c.deadline - c.assigned_at == pytest.approx(
            max(0.5, c.size / 4_001.0 * 4.0))
    clock.step(0.6)
    p.answer(MINER_A)
    clock.step(0.6)
    p.answer(MINER_B)
    assert p.miner(MINER_B).rate_ewma is not None
    p.request(CLIENT_Y, "target", 999, 1 << 50)
    clock.step(0.6)
    p.answer(MINER_A)
    p.answer(MINER_B)
    assert p.replies(CLIENT_Y) == [scan_until("target", 0, 1000,
                                              1 << 50)[:2]]


def _drive(clock, seed, qos):
    """Seeded joins, drops, honest Results (requests of at most 2^12
    nonces), clock steps and sweeps; each request comes from a tenant of
    its own and its reply must equal the oracle's. About one miner in
    three is slow: picked to answer, it answers one time in ten, so its
    leases blow and its chunks are re-issued."""
    rng = np.random.default_rng(seed)
    p = Pair(qos=qos, grace_s=float(rng.choice([0.5, 2.0])),
             floor_s=0.3, factor=2.0,
             quarantine_after=int(rng.integers(1, 4)),
             queue_alarm_s=float(rng.choice([0.0, 1.5])),
             desperation=bool(rng.random() < 0.8),
             qos_kw={"wholesale_s": 2.0, "chunk_s": 1.0} if qos else None)
    next_miner, next_tenant = 201, 1001
    asked, dropped, slow = {}, set(), set()

    def join():
        nonlocal next_miner
        if rng.random() < 0.35:
            slow.add(next_miner)
        p.join(next_miner)
        next_miner += 1

    for _ in range(int(rng.integers(2, 5))):
        join()
    for step in range(120):
        r = rng.random()
        if r < 0.2:
            mx = int(rng.integers(0, 1 << 12))
            target = int(rng.choice([0, 0, 0, 1 << 60, 1 << 52]))
            data = f"drive {seed}.{step}"
            p.request(next_tenant, data, mx, target)
            asked[next_tenant] = (data, mx, target)
            next_tenant += 1
        elif r < 0.6 and p.busy():
            busy = p.busy()
            m = busy[int(rng.integers(0, len(busy)))]
            if m not in slow or rng.random() < 0.1:
                p.answer(m)
        elif r < 0.75:
            clock.step(float(rng.choice([0.1, 0.4, 1.0, 3.0])))
        elif r < 0.87:
            p.sweep()
        elif r < 0.92 and len(p.port.miners) > 1:
            miners = [m.conn_id for m in p.port.miners]
            p.drop(miners[int(rng.integers(0, len(miners)))])
        elif r < 0.97:
            join()
        elif asked:
            t = int(rng.choice(sorted(asked)))
            if t not in dropped:
                dropped.add(t)
                p.drop(t)
    for _ in range(2):                # the drain: two fresh miners
        join()
    for _ in range(1000):
        if not (p.busy() or len(p.port.tenant_plane) or p.port.inflight):
            break
        if p.busy():
            for m in p.busy():        # every miner answers its head
                if m in p.busy():
                    p.answer(m)
        else:
            join()
        clock.step(0.05)
        p.sweep()
    for t, (data, mx, target) in asked.items():
        if t in dropped:
            continue
        want = scan_until(data, 0, mx + 1, target)[:2]
        assert p.replies(t) == [want], (t, data, mx, target)
    return p


@pytest.mark.parametrize("qos", [False, True], ids=["fifo", "qos"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_drive_equals_jax(clock, seed, qos):
    p = _drive(clock, seed, qos)
    assert p.port.stats["results_sent"] > 0
    assert p.port.stats["leases_blown"] and p.port.stats["reissues"]


# ------------------------------------------------------------- env reader

LEASE_KNOBS = {"LEASE_GRACE_S": "7.5", "LEASE_FACTOR": "3.25",
               "LEASE_FLOOR_S": "0.75", "LEASE_TICK_S": "0.125",
               "LEASE_QUARANTINE": "5", "QUEUE_ALARM_S": "12.5"}


def test_lease_from_env_equals_jax(monkeypatch):
    for k in LEASE_KNOBS:
        monkeypatch.delenv("DBM_" + k, raising=False)
        monkeypatch.delenv("DBMT_" + k, raising=False)
    assert vars(config.lease_from_env()) == vars(ref_config.lease_from_env())
    assert vars(config.LeaseParams()) == vars(ref_config.LeaseParams())
    for k, v in LEASE_KNOBS.items():
        monkeypatch.setenv("DBM_" + k, v)
        monkeypatch.setenv("DBMT_" + k, v)
    port, ref = config.lease_from_env(), ref_config.lease_from_env()
    assert vars(port) == vars(ref)
    assert port.grace_s == 7.5 and port.quarantine_after == 5
    monkeypatch.setenv("DBMT_LEASE_FLOOR_S", "not a number")
    assert config.lease_from_env().floor_s == config.LeaseParams().floor_s


def test_chunk_fields_equal_jax():
    """The port's chunk record carries the JAX one's lease fields."""
    port = Chunk(1, "d", 0, 9)
    ref = ref_mp_mod.Chunk(1, "d", 0, 9)
    for name in ("deadline", "lease_started", "lease_blown", "reissued",
                 "assigned_at", "cancelled", "coalesce_id"):
        assert getattr(port, name) == getattr(ref, name), name
