"""The rest of the port's scheduler against the JAX package's, in lockstep.

Striping with the rate-hint JOIN, the result cache, admission and
shedding, tenant weights, the lazy QoS pump, request tracing and the
adapt plane, all ON, as the JAX package runs them by default (a case
keeps the adapt plane off on both sides). The port's scheduler and the
JAX ``Scheduler`` are fed the same events (joins with and without a rate
hint, requests, Results with and without a miner's span, false claims,
drops, clock steps and sweeps) over recording fake servers, with one
fake clock read by both packages' scheduler, miner plane, tenant plane
and request traces (the port's admission buckets read it through its
tenant plane and its adapt controllers through its scheduler; the JAX
ones are handed it through ``clock=``). After every event both have
written the same messages, closed the same conns, and hold the same
counters, miners (pending chunks, rates and their hint flags, trust),
queue, tenants (weights, deficits, buckets, sheds), DRR ring, lazy-pump
indexes, cache, adapt controllers (values, histories, the live knobs
and the per-miner overrides), stitched request traces with their
export tracks, and the same metric series in their registries, family
by family (but the JAX families the port leaves out). Plus the new
``DBMT_*`` readers against their ``DBM_*`` twins, and the miner's
rate-hint probe.
"""

import random
import time
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
from distributed_bitcoinminer_tpu.utils import metrics as ref_metrics_mod
from distributed_bitcoinminer_tpu_torch.apps import miner as miner_mod
from distributed_bitcoinminer_tpu_torch.apps import miner_plane as mp_mod
from distributed_bitcoinminer_tpu_torch.apps import scheduler as sched_mod
from distributed_bitcoinminer_tpu_torch.apps import tenant_plane as tp_mod
from distributed_bitcoinminer_tpu_torch.apps.scheduler import (STAT_COUNTERS,
                                                               Scheduler)
from distributed_bitcoinminer_tpu_torch.bitcoin.hash import (hash_op,
                                                             scan_until)
from distributed_bitcoinminer_tpu_torch.bitcoin.message import (
    Message, new_join, new_request, new_result)
from distributed_bitcoinminer_tpu_torch.utils import config
from distributed_bitcoinminer_tpu_torch.utils import metrics as metrics_mod
from distributed_bitcoinminer_tpu_torch.utils.trace import SPAN_PHASES
from tests.test_torch_lease import Clock, honest


@pytest.fixture
def clock(monkeypatch):
    """One fake ``time.monotonic`` for both packages' scheduler, planes
    and request traces (the rest of ``time`` stays real)."""
    c = Clock()
    fake = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                    if not k.startswith("_")})
    fake.monotonic = c.monotonic
    for mod in (sched_mod, mp_mod, tp_mod, metrics_mod, ref_sched_mod,
                ref_mp_mod, ref_tp_mod, ref_metrics_mod):
        monkeypatch.setattr(mod, "time", fake)
    return c

MINER_A, MINER_B, MINER_C = 101, 102, 103
TEN_X, TEN_Y, TEN_Z, TEN_W = 1, 2, 3, 4


class FakeServer:
    """Records writes as wire tuples and closed conns."""

    def __init__(self):
        self.writes = []
        self.closed = []

    def write(self, conn_id, payload):
        m = Message.from_json(payload)
        self.writes.append((conn_id, int(m.type), m.data, m.lower, m.upper,
                            m.hash, m.nonce, m.target))

    def close_conn(self, conn_id):
        self.closed.append(conn_id)


class Pair:
    """The port's scheduler and the JAX package's with the same settings:
    ``qos``, ``stripe``, ``cache``, ``lease``, ``verify`` and ``adapt``
    are dicts of the param blocks' fields over the JAX package's defaults
    (every feature on, the lazy pump, the adapt plane with its admission
    controller, no audits; the port's own default pump is the eager one
    and its adapt plane mounts no admission controller, so its side is
    given ``lazy=True`` and ``admit=True`` unless ``qos`` or ``adapt``
    say otherwise)."""

    def __init__(self, clock, qos=None, stripe=None, cache=None, lease=None,
                 verify=None, seed=7, qos_params=None, adapt=None):
        verify = {"audit_p": 0.0, **(verify or {})}
        qos_params = qos_params or (
            config.QosParams(**{"lazy": True, **(qos or {})}),
            ref_config.QosParams(**(qos or {})))
        self.port_server, self.ref_server = FakeServer(), FakeServer()
        self.port = Scheduler(
            self.port_server, qos=qos_params[0],
            coalesce=config.CoalesceParams(),
            lease=config.LeaseParams(**(lease or {})),
            verify=config.VerifyParams(**verify),
            audit_rng=random.Random(seed),
            stripe=config.StripeParams(**(stripe or {})),
            cache=config.CacheParams(**(cache or {})),
            adapt=config.AdaptParams(**{"admit": True, **(adapt or {})}))
        self.ref = RefScheduler(
            self.ref_server, qos=qos_params[1],
            coalesce=ref_config.CoalesceParams(),
            lease=ref_config.LeaseParams(**(lease or {})),
            verify=ref_config.VerifyParams(**verify),
            audit_rng=random.Random(seed),
            stripe=ref_config.StripeParams(**(stripe or {})),
            cache=ref_config.CacheParams(**(cache or {})),
            adapt=ref_config.AdaptParams(**(adapt or {})),
            clock=clock.monotonic)

    def both(self, fn):
        fn(self.port)
        fn(self.ref)
        self.check()

    def join(self, conn, rate=0):
        self.both(lambda s: s._on_join(conn, new_join(rate=rate)))

    def request(self, conn, data, max_nonce, target=0, lower=0):
        self.both(lambda s: s._on_request(
            conn, new_request(data, lower, max_nonce, target)))

    def drop(self, conn):
        self.both(lambda s: s._on_drop(conn))

    def sweep(self):
        self.both(lambda s: s.sweep())

    def set_weight(self, tenant, weight):
        self.both(lambda s: s.set_tenant_weight(tenant, weight))

    def head(self, miner):
        return self.port.miner_plane.find_miner(miner).pending[0]

    def answer(self, miner, pair=None, echo=True, span=None):
        """The miner answers its oldest chunk: honestly, or with
        ``pair(chunk)``'s ``(hash, nonce)``; the target echoed unless
        ``echo`` is off (a stock miner); ``span`` rides the Result."""
        c = self.head(miner)
        h, nonce = (pair or honest)(c)
        msg = Message.from_json(new_result(h, nonce, c.target if echo else 0,
                                           span=span).to_json())
        self.both(lambda s: s._on_result(miner, msg))

    def set_rates(self, rate, miners=()):
        """A warm pool: the pool's rate and ``miners``' pinned alike."""
        for s in (self.port, self.ref):
            s.miner_plane.pool_rate = rate
            for conn in miners:
                s.miner_plane.find_miner(conn).rate_ewma = rate
        self.check()

    def set_miner(self, conn, **fields):
        for s in (self.port, self.ref):
            m = s.miner_plane.find_miner(conn)
            for k, v in fields.items():
                setattr(m, k, v)
        self.check()

    def busy(self):
        return [m.conn_id for m in self.port.miners if m.pending]

    def miner(self, conn):
        return self.port.miner_plane.find_miner(conn)

    def drain(self):
        while self.busy():
            self.answer(self.busy()[0])

    @staticmethod
    def state(s):
        mp = s.miner_plane
        miners = [(m.conn_id, m.quarantined, m.blown_streak, m.trust,
                   m.rate_ewma, m.rate_hinted, m.win_t0, m.win_nonces,
                   [(c.job_id, c.idx, c.lower, c.upper, c.target,
                     c.cancelled, c.lease_blown, c.reissued,
                     c.lease_started, c.deadline, c.coalesce_id)
                    for c in m.pending])
                  for m in mp.miners]
        plane = s.qos_plane
        tenants = {t: (st.weight, st.deficit, st.inflight,
                       st.granted_nonces, st.granted_chunks, st.shed,
                       st.bucket.rate, st.bucket.burst, st.bucket._tokens,
                       st.bucket._t)
                   for t, st in plane.tenants.items()}
        inflight = [(j, r.conn_id, r.qos_mode, r.num_chunks,
                     list(r.answered), r.next_chunk, r.granted_chunks,
                     list(r.chunk_bounds or []), r.min_hash, r.min_nonce,
                     r.weak)
                    for j, r in s._inflight.items()]
        queued = s.queue if isinstance(s, RefScheduler) \
            else s.tenant_plane.requests()
        tp = s.tenant_plane
        adapt = s.adapt_plane
        return {
            "traces": [(k, t.to_dict()) for k, t in tp.traces.items()],
            "tracks": sorted(tp.tracks.items("trace_track")),
            "adapt": None if adapt is None
            else (adapt.state(), adapt.histories()),
            "knobs": (s.qos.chunk_s, mp.stripe.chunk_s, mp.coalesce.small_s),
            "overrides": dict(mp.chunk_s_overrides),
            "miners": miners,
            "parked": [(c.job_id, c.idx) for c in mp.parked],
            "pool": (mp.pool_rate, mp._pool_hinted),
            "inflight": inflight,
            "queue": [(r.conn_id, r.data, r.lower, r.upper, r.target)
                      for r in queued],
            "tenants": tenants,
            "ring": list(plane.ring), "topped": sorted(plane._topped),
            "quantum": plane._lazy_quantum,
            "chunked": {t: list(d) for t, d in s._qos_chunked_reqs.items()},
            "tenant_inflight": dict(s._tenant_inflight),
            "cache": None if s.results is None else list(s.results._d.items()),
            "audits": sorted(s._audits),
        }

    def check(self):
        assert self.port_server.writes == self.ref_server.writes
        assert self.port_server.closed == self.ref_server.closed
        for name in STAT_COUNTERS:
            assert self.port.stats[name] == self.ref.stats[name], name
        assert self.state(self.port) == self.state(self.ref)
        if series(self.port.metrics) != series(self.ref.metrics):
            port, ref = (families(s.metrics.snapshot())
                         for s in (self.port, self.ref))
            for name in sorted(set(port) | set(ref)):
                assert port.get(name) == ref.get(name), name
            assert port == ref

    def replies(self, conn):
        return [(w[5], w[6]) for w in self.port_server.writes
                if w[0] == conn and w[1] == 2]

    def requests_to(self, conn):
        return [(w[2], w[3], w[4], w[7]) for w in self.port_server.writes
                if w[0] == conn and w[1] == 1]


#: The JAX package's metric families the port does not register: it has
#: no until-tier degrade path (``model.until_degraded``) and no batch
#: stack cache (``model.batch_stack_cache``), and it counts fresh launch
#: signatures (``trace.fresh_launches``, ``trace.fresh_launch_worst_s``,
#: ``trace.launch_storms``) where the JAX package counts jit compiles.
LEFT_OUT_FAMILIES = ("model.until_degraded", "model.batch_stack_cache",
                     "trace.jit_compiles", "trace.jit_compile_worst_s",
                     "trace.recompile_storms")


def series(registry) -> dict:
    """Every series of a scheduler's registry (it mounts nothing) by
    kind and family, as raw values: the cheap form of its snapshot."""
    return {(kind, name): {key: (m.buckets, tuple(m._counts), m._sum)
                           if kind == "histograms" else m._value
                           for key, m in family.items()}
            for kind, by_name in registry._families.items()
            for name, family in by_name.items()}


def families(snap: dict) -> dict:
    """A registry snapshot by family: ``{(kind, name): {series: value}}``
    with the left-out families dropped, plus the overflow count."""
    out: dict = {("series_overflow", ""): snap["series_overflow"]}
    for kind in ("counters", "gauges", "histograms", "ewmas"):
        for key, value in snap[kind].items():
            name = key.split("{", 1)[0]
            if name not in LEFT_OUT_FAMILIES:
                out.setdefault((kind, name), {})[key] = value
    return out


def chunks_written(p):
    return sum(1 for w in p.port_server.writes if w[1] == 1)


# ------------------------------------------------------------- striping

@pytest.mark.parametrize("case", ["warm", "cold", "trust", "depth", "fifo"])
def test_stripe_plans_equal_jax(clock, case):
    """A wholesale request on a warm pool is striped: each miner's share
    in chunks of ``chunk_s`` seconds at its rate (weighted by trust; at
    most ``depth``), indices ascending across miners; a cold pool gives
    one chunk a miner. Every answer is the oracle's."""
    qos = {"enabled": case != "fifo", "wholesale_s": 1e9}
    stripe = {"chunk_s": 1.0, "depth": 3 if case == "depth" else 8}
    p = Pair(clock, qos=qos, stripe=stripe)
    p.join(MINER_A)
    p.join(MINER_B)
    if case != "cold":
        p.set_rates(1_000.0, (MINER_A, MINER_B))
    if case == "trust":
        p.set_miner(MINER_B, trust=0.5)
    p.request(TEN_X, "striped", 9_999)
    want_a = {"warm": 5, "cold": 1, "trust": 5, "depth": 3, "fifo": 5}[case]
    want_b = {"trust": 8, "cold": 1, "depth": 3}.get(case, 5)
    assert len(p.requests_to(MINER_A)) == want_a
    assert len(p.requests_to(MINER_B)) == want_b
    assert p.port.stats["chunks_striped"] == want_a + want_b - 2
    plans = p.port.metrics.snapshot()["histograms"]["stripe_chunks_per_share"]
    assert (plans["count"], plans["sum"]) == (2, want_a + want_b)
    lowers = [w[3] for w in p.port_server.writes if w[1] == 1]
    assert lowers == sorted(lowers)
    p.drain()
    assert p.replies(TEN_X) == [scan_min("striped", 0, 10_000)]


def test_striped_difficulty_prefix_release(clock):
    """A difficulty request striped over two miners releases at the first
    qualifying chunk once every lower chunk answered, whichever miner
    holds them."""
    p = Pair(clock, qos={"wholesale_s": 1e9}, stripe={"chunk_s": 1.0})
    p.join(MINER_A)
    p.join(MINER_B)
    p.set_rates(500.0, (MINER_A, MINER_B))
    target = 1 << 58
    p.request(TEN_X, "striped until", 3_999, target)
    assert p.port.stats["chunks_striped"] == 6      # 4 chunks a miner
    while p.miner(MINER_B).pending:
        p.answer(MINER_B)                # the upper half first: held
    assert p.replies(TEN_X) == []
    while not p.replies(TEN_X):
        p.answer(MINER_A)
    h, nonce, found = scan_until("striped until", 0, 4_000, target)
    assert found and p.replies(TEN_X) == [(h, nonce)]


# ------------------------------------------------------ rate-hint JOIN

def test_rate_hint_join_equals_jax(clock):
    """A hint seeds the miner's rate (capped) and an empty pool's; a later
    hint leaves the pool's; each sweep decays both; the plan stripes from
    them; the first measured window replaces the hint outright."""
    p = Pair(clock, qos={"wholesale_s": 1e9}, stripe={"chunk_s": 0.5})
    p.join(MINER_A, rate=2_000)
    assert p.miner(MINER_A).rate_hinted
    assert p.port.miner_plane.pool_rate == 2_000.0
    p.join(MINER_B, rate=10 ** 13)
    assert p.miner(MINER_B).rate_ewma == 1e12
    assert p.port.miner_plane.pool_rate == 2_000.0
    p.join(MINER_C)
    p.sweep()
    p.sweep()
    assert p.miner(MINER_A).rate_ewma == pytest.approx(2_000 * 0.98 ** 2)
    assert p.port.miner_plane.pool_rate == pytest.approx(2_000 * 0.98 ** 2)
    p.request(TEN_X, "hinted", 5_999)
    # A: 2000 x 0.98^2 x 0.5 s a chunk; B: one chunk; C: the pool's rate.
    assert [len(p.requests_to(m)) for m in (MINER_A, MINER_B, MINER_C)] \
        == [3, 1, 3]
    clock.step(0.6)
    size = p.head(MINER_A).size
    p.answer(MINER_A)                 # the first window: a measured rate
    assert not p.miner(MINER_A).rate_hinted
    assert p.miner(MINER_A).rate_ewma == pytest.approx(size / 0.6)
    assert p.port.miner_plane.pool_rate == p.miner(MINER_A).rate_ewma
    assert p.miner(MINER_B).rate_hinted
    p.drain()
    assert p.replies(TEN_X) == [scan_min("hinted", 0, 6_000)]


def test_rate_hint_discarded_on_trust_fail(clock):
    """A failed claim discards the liar's unconfirmed hint (its stripe
    share falls back to the pool's rate)."""
    p = Pair(clock, qos={"wholesale_s": 1e9}, stripe={"chunk_s": 1.0})
    p.join(MINER_A, rate=50_000)
    p.join(MINER_B)
    p.request(TEN_X, "liar", 1_999)
    c = p.head(MINER_A)
    p.answer(MINER_A, pair=lambda c: (hash_op(c.data, c.lower) ^ 1,
                                      c.lower))
    assert p.port.stats["claims_failed"] == 1
    assert p.miner(MINER_A).rate_ewma is None
    assert not p.miner(MINER_A).rate_hinted
    assert c.lower == 0
    p.drain()
    assert p.replies(TEN_X) == [scan_min("liar", 0, 2_000)]


# ---------------------------------------------------------------- cache

def test_cache_replays_at_arrival_without_a_chunk(clock):
    p = Pair(clock)
    p.join(MINER_A)
    p.join(MINER_B)
    p.request(TEN_X, "cached", 4_999)
    p.drain()
    before = chunks_written(p)
    p.request(TEN_Y, "cached", 4_999)
    assert chunks_written(p) == before
    assert p.replies(TEN_Y) == p.replies(TEN_X) == \
        [scan_min("cached", 0, 5_000)]
    assert (p.port.stats["cache_hits"], p.port.stats["cache_misses"],
            p.port.stats["cache_stores"]) == (1, 1, 1)


@pytest.mark.parametrize("qos", [{}, {"lazy": False}, {"enabled": False}],
                         ids=["lazy", "eager", "fifo"])
def test_cache_replays_a_duplicate_at_dispatch(clock, qos):
    """A duplicate queued behind its in-flight original is answered from
    the cache when its turn comes (through each pump), and no chunk of it
    is written."""
    p = Pair(clock, qos=qos)
    p.join(MINER_A)
    p.request(TEN_X, "dup", 2_999)
    p.request(TEN_Y, "dup", 2_999)
    p.request(TEN_Z, "after", 99)
    assert len(p.port.tenant_plane) == 2
    p.answer(MINER_A)
    assert p.replies(TEN_Y) == p.replies(TEN_X) == [scan_min("dup", 0, 3_000)]
    assert p.requests_to(MINER_A)[-1][0] == "after"
    assert p.port.stats["cache_hits"] == 1
    assert p.port.stats["cache_misses"] == 3
    p.drain()


def test_weak_merge_is_not_stored(clock):
    p = Pair(clock)
    p.join(MINER_A)
    target = 1 << 62
    p.request(TEN_X, "weak", 999, target)
    p.answer(MINER_A, echo=False)        # a stock miner: the merge is weak
    assert p.port.stats["cache_stores"] == 0
    p.request(TEN_Y, "weak", 999, target)
    assert p.port.stats["cache_hits"] == 0
    p.answer(MINER_A)
    assert p.port.stats["cache_stores"] == 1


def test_cache_evicts_the_least_recent(clock):
    p = Pair(clock, cache={"size": 2})
    p.join(MINER_A)
    for data in ("one", "two"):
        p.request(TEN_X, data, 99)
        p.drain()
    p.request(TEN_Y, "one", 99)          # a hit: "one" is the most recent
    p.request(TEN_X, "three", 99)
    p.drain()                            # stores "three", evicts "two"
    p.request(TEN_Y, "one", 99)
    assert p.port.stats["cache_hits"] == 2
    p.request(TEN_Y, "two", 99)
    assert p.port.stats["cache_hits"] == 2 and p.busy()
    p.drain()
    assert len(p.port.results) == 2


# ------------------------------------------------------------ admission

def test_bucket_refills_under_the_fake_clock(clock):
    p = Pair(clock, qos={"rate": 2.0, "burst": 1.0})
    p.join(MINER_A)
    p.request(TEN_X, "first", 9)
    clock.step(0.25)
    p.request(TEN_X, "too soon", 9)      # half a token: shed
    assert p.port.stats["qos_shed"] == 1
    assert p.port_server.closed == [TEN_X]
    clock.step(0.5)
    p.request(TEN_Y, "y", 9)
    clock.step(0.5)
    p.request(TEN_Y, "y again", 9)       # refilled
    assert p.port.stats["qos_shed"] == 1
    p.drain()


def test_shed_at_admission_closes_and_purges_siblings(clock):
    p = Pair(clock, qos={"rate": 0.01, "burst": 2.0})
    p.join(MINER_A)
    p.request(TEN_X, "in flight", 999)
    p.request(TEN_X, "queued", 99)
    p.request(TEN_X, "shed", 99)
    assert p.port.stats["qos_shed"] == 2       # the arrival + its sibling
    assert p.port_server.closed == [TEN_X]
    assert len(p.port.tenant_plane) == 0
    assert p.port.qos_plane.tenants[TEN_X].shed == 2
    p.drain()
    assert p.replies(TEN_X) == [scan_min("in flight", 0, 1_000)]


def test_overload_sheds_the_oldest_queued(clock):
    p = Pair(clock, qos={"max_queued": 2})
    p.join(MINER_A)
    p.request(TEN_X, "elephant", 9_999)
    for t in (TEN_Y, TEN_Z, TEN_W):
        p.request(t, f"queued {t}", 99)
    assert p.port.stats["qos_shed"] == 1
    assert p.port_server.closed == [TEN_Y]
    assert [r.conn_id for r in p.port.tenant_plane.requests()] == [TEN_Z, TEN_W]
    p.drain()
    assert p.replies(TEN_Y) == []
    assert p.replies(TEN_W) == [scan_min(f"queued {TEN_W}", 0, 100)]


def test_cache_replays_spend_no_token(clock):
    p = Pair(clock, qos={"rate": 0.01, "burst": 1.0})
    p.join(MINER_A)
    p.request(TEN_X, "once", 99)
    p.drain()
    p.request(TEN_X, "once", 99)
    p.request(TEN_X, "once", 99)
    assert p.port.stats["cache_hits"] == 2 and p.port.stats["qos_shed"] == 0
    p.request(TEN_X, "new", 99)
    assert p.port.stats["qos_shed"] == 1


# -------------------------------------------------------------- weights

def _contended(p, grants):
    """Two tenants' chunked elephants on two miners at a pinned rate;
    answer ``grants`` chunks, then the granted-nonce share of each."""
    p.join(MINER_A)
    p.join(MINER_B)
    p.set_rates(100.0)
    p.request(TEN_Y, "light", 99_999)
    p.request(TEN_X, "heavy", 99_999)
    for i in range(grants):
        p.answer(p.busy()[i % len(p.busy())])
    plane = p.port.qos_plane
    total = plane.tenants[TEN_X].granted_nonces \
        + plane.tenants[TEN_Y].granted_nonces
    return plane.tenants[TEN_X].granted_nonces / total


QOS_CONTENDED = {"wholesale_s": 0.1, "chunk_s": 0.5}


@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "eager"])
def test_set_tenant_weight_share_equals_jax(clock, lazy):
    p = Pair(clock, qos={**QOS_CONTENDED, "lazy": lazy})
    p.set_weight(TEN_X, 3.0)
    share = _contended(p, 160)
    assert share == pytest.approx(0.75, abs=0.05)


def test_env_weights_share_equals_jax(clock, monkeypatch):
    """The port server's QoS plane from the environment (the eager
    pump) against the JAX one's, pinned to the same pump."""
    for prefix in ("DBMT", "DBM"):
        monkeypatch.setenv(f"{prefix}_QOS_WEIGHTS", f"{TEN_X}:3,bad,:")
        monkeypatch.setenv(f"{prefix}_QOS_WHOLESALE_S", "0.1")
        monkeypatch.setenv(f"{prefix}_QOS_CHUNK_S", "0.5")
    monkeypatch.setenv("DBM_QOS_LAZY", "0")
    params = (config.qos_from_env(), ref_config.qos_from_env())
    assert params[0].weights == params[1].weights == ((str(TEN_X), 3.0),)
    p = Pair(clock, qos_params=params)
    share = _contended(p, 160)
    assert share == pytest.approx(0.75, abs=0.05)


# ------------------------------------------------------ the lazy pump

def _span(rng):
    """A miner's chunk span drawn from ``rng``: every phase, and now and
    then a shared launch's id and lanes."""
    span = {k: round(float(rng.uniform(0.0, 1.5)), 6) for k in SPAN_PHASES}
    if rng.random() < 0.3:
        span.update(launch=int(rng.integers(1, 9)), lanes=2)
    return span


def _storm(clock, seed, adapt=None):
    rng = np.random.default_rng(seed)
    p = Pair(clock, adapt=adapt,
             qos={"wholesale_s": float(rng.choice([0.2, 1.0])),
                  "chunk_s": float(rng.choice([0.05, 0.2])),
                  "depth": int(rng.integers(1, 4)),
                  "max_queued": int(rng.choice([0, 3, 6])),
                  "rate": float(rng.choice([0.0, 0.5])), "burst": 2.0},
             stripe={"chunk_s": float(rng.choice([0.05, 0.3])),
                     "depth": int(rng.integers(2, 6))},
             cache={"size": 4}, lease={"grace_s": 5.0, "floor_s": 1.0},
             seed=seed)
    miners = []
    next_miner = 101
    tenants = [TEN_X, TEN_Y, TEN_Z, TEN_W, 5]
    sent = []
    sent_by = {t: set() for t in tenants}
    for step in range(140):
        r = rng.random()
        if r < 0.08 or len(miners) < 2:
            rate = int(rng.choice([0, 0, 3_000, 40_000]))
            p.join(next_miner, rate=rate)
            miners.append(next_miner)
            next_miner += 1
        elif r < 0.45:
            t = int(rng.choice(tenants))
            if sent and rng.random() < 0.2:
                data, mx, target = sent[int(rng.integers(0, len(sent)))]
            else:
                big = rng.random() < 0.25
                mx = int(rng.integers(2_000, 12_000) if big
                         else rng.integers(0, 80))
                target = 1 << 60 if rng.random() < 0.15 else 0
                data = f"{'el' if big else 'mo'} {t}.{step}"
                sent.append((data, mx, target))
            sent_by[t].add((data, mx, target))
            p.request(t, data, mx, target)
        elif r < 0.8 and p.busy():
            busy = p.busy()
            m = busy[int(rng.integers(0, len(busy)))]
            if rng.random() < 0.05:
                p.answer(m, pair=lambda c: (hash_op(c.data, c.lower) ^ 1,
                                            c.lower))
            else:
                p.answer(m, span=_span(rng) if rng.random() < 0.5
                         else None)
        elif r < 0.88:
            clock.step(float(rng.choice([0.05, 0.3, 0.7, 2.5])))
            p.sweep()
        elif r < 0.92 and len(miners) > 2:
            m = miners.pop(int(rng.integers(0, len(miners))))
            p.drop(m)
        elif r < 0.95:
            p.drop(int(rng.choice(tenants)))
        else:
            p.set_weight(int(rng.choice(tenants)),
                         float(rng.choice([0.5, 2.0, 4.0])))
    for _ in range(400):
        if not (p.busy() or len(p.port.tenant_plane) or p.port.inflight):
            break
        if p.busy():
            p.answer(p.busy()[0])
        else:
            clock.step(1.0)
            p.sweep()
    return p, sent_by


STORM_SEEDS = range(10)
#: The storms' adapt settings: the JAX defaults (on) for every seed, plus
#: the plane off and per-miner chunk setpoints on two seeds each.
STORM_CASES = [(seed, "on") for seed in STORM_SEEDS] \
    + [(seed, mode) for seed in (0, 1) for mode in ("off", "per_miner")]
ADAPT_MODES = {"on": {}, "off": {"enabled": False},
               "per_miner": {"per_miner": True}}


@pytest.mark.parametrize("seed,adapt", STORM_CASES,
                         ids=[f"{s}-{a}" for s, a in STORM_CASES])
def test_lazy_pump_storms_equal_jax(clock, seed, adapt):
    """Seeded storms of joins (hinted or not), requests (mice, elephants,
    targets, repeats), answers (half with a miner's span), false claims,
    miner and client drops, weight changes, clock steps and sweeps, all
    features on: the grants (every write), closes and state, the adapt
    controllers and the stitched traces included, match the JAX lazy
    pump's after every event, and every Result a client gets is the
    oracle's answer to one of its requests (the scanned range is
    ``[0, maxNonce+1]``)."""
    p, sent_by = _storm(clock, seed, ADAPT_MODES[adapt])
    assert p.port.stats["results_sent"] > 0
    oracle = {}
    for conn, kind, *_, h, nonce, _t in p.port_server.writes:
        if kind != 2:
            continue
        answers = set()
        for data, mx, target in sent_by[conn]:
            key = (data, mx, target)
            if key not in oracle:
                oracle[key] = scan_until(data, 0, mx + 1, target)[:2]
            answers.add(oracle[key])
        assert (h, nonce) in answers


def test_storms_exercise_every_feature(clock):
    """The storms between them stripe, replay at arrival, shed, grant
    through the lazy pump, catch false claims, fold miners' spans into
    the traces and move each adapt controller."""
    totals = dict.fromkeys(("chunks_striped", "cache_hits", "qos_shed",
                            "qos_grants", "claims_failed",
                            "qos_window_grants"), 0)
    adjusted = dict.fromkeys(("chunk_adjustments", "window_adjustments",
                              "admit_adjustments"), 0)
    spans = 0
    for seed in STORM_SEEDS:
        p, _ = _storm(clock, seed)
        for k in totals:
            totals[k] += p.port.stats[k]
        state = p.port.adapt_plane.state()
        for k in adjusted:
            adjusted[k] += state[k]
        spans += sum(e["event"] == "miner_span"
                     for _, t in p.port.tenant_plane.traces.items()
                     for e in t.events)
    assert all(totals.values()), totals
    assert all(adjusted.values()), adjusted
    assert spans > 0


def test_per_miner_setpoints_fork_and_stripe_equal_jax(clock):
    """Per-miner chunk setpoints: with the miners' measured rates 20x
    apart, slow force spans on one and fast ones on the other fork a
    value a miner (``chunk_s_overrides``), which the stripe planner then
    reads; the values, overrides and plans match the JAX package's."""
    p = Pair(clock, qos={"wholesale_s": 0.1, "chunk_s": 0.5},
             stripe={"chunk_s": 0.5}, adapt={"per_miner": True})
    p.join(MINER_A)
    p.join(MINER_B)
    p.set_rates(1_000.0, (MINER_A,))
    p.set_miner(MINER_B, rate_ewma=20_000.0)
    p.request(TEN_X, "per miner", 199_999)
    forked = set()
    for _ in range(60):
        busy = p.busy()
        if not busy:
            break
        for m in busy:
            p.answer(m, span={"force_s": 4.0 if m == MINER_A else 0.01,
                              "gap_s": 0.0})
        p.set_miner(MINER_A, rate_ewma=1_000.0)
        p.set_miner(MINER_B, rate_ewma=20_000.0)
        clock.step(1.0)
        p.sweep()
        forked |= set(p.port.miner_plane.chunk_s_overrides)
    assert forked == {MINER_A, MINER_B}
    overrides = dict(p.port.miner_plane.chunk_s_overrides)
    assert overrides[MINER_A] < overrides[MINER_B]
    p.drain()
    assert p.replies(TEN_X) == [scan_min("per miner", 0, 200_000)]


# ------------------------------------------------------ the env readers

ENV_CASES = [
    {},
    {"QOS_CHUNK_S": "0.25", "QOS_MAX_CHUNKS": "17", "QOS_DEPTH": "3",
     "QOS_WHOLESALE_S": "2.5", "QOS_MAX_QUEUED": "9",
     "QOS_MAX_INFLIGHT": "4", "QOS_RATE": "1.5", "QOS_BURST": "3",
     "QOS_WEIGHT_DEFAULT": "2", "QOS_WEIGHTS": "1:3, 2:0.5,x,3:y,:,4:",
     "STRIPE_CHUNK_S": "0.5",
     "STRIPE_DEPTH": "4", "CACHE": "0", "CACHE_SIZE": "7"},
    {"QOS_CHUNK_S": "0", "QOS_MAX_CHUNKS": "-3", "QOS_DEPTH": "0",
     "QOS_MAX_QUEUED": "-1", "QOS_MAX_INFLIGHT": "-2", "QOS_RATE": "-4",
     "QOS_BURST": "0.2", "STRIPE_CHUNK_S": "-1", "STRIPE_DEPTH": "0",
     "CACHE_SIZE": "-5"},
    {"QOS_CHUNK_S": "abc", "QOS_DEPTH": "1.5", "QOS_RATE": "fast",
     "CACHE": "", "CACHE_SIZE": "big",
     "QOS_WEIGHTS": "garbage"},
]


@pytest.mark.parametrize("case", range(len(ENV_CASES)))
def test_env_readers_equal_jax(monkeypatch, case):
    for key, value in ENV_CASES[case].items():
        monkeypatch.setenv(f"DBMT_{key}", value)
        monkeypatch.setenv(f"DBM_{key}", value)
    for port_fn, ref_fn in ((config.qos_from_env, ref_config.qos_from_env),
                            (config.stripe_from_env,
                             ref_config.stripe_from_env),
                            (config.cache_from_env,
                             ref_config.cache_from_env)):
        port, ref = port_fn(), ref_fn()
        for field in set(port.__dataclass_fields__) - {"lazy"}:
            assert getattr(port, field) == getattr(ref, field), field
    assert config.qos_from_env().lazy is False


def test_param_defaults_equal_jax():
    """The JAX package's defaults, but the pump: the port's is the eager
    one (``QosParams.lazy``, a constructor field with no knob)."""
    for port, ref in ((config.QosParams(), ref_config.QosParams()),
                      (config.StripeParams(), ref_config.StripeParams()),
                      (config.CacheParams(), ref_config.CacheParams()),
                      (config.StripeParams(chunk_s=0),
                       ref_config.StripeParams(chunk_s=0))):
        for field in set(port.__dataclass_fields__) - {"lazy"}:
            assert getattr(port, field) == getattr(ref, field), field
    assert (config.QosParams().lazy, ref_config.QosParams().lazy) == \
        (False, True)


# ----------------------------------------------------- the rate probe

class _Raising:
    def search(self, lower, upper):
        raise RuntimeError("kernel launch failed")


def test_measure_rate_hint_on_the_cpu_and_raising():
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
    rate = miner_mod.measure_rate_hint(NonceSearcher("probe", device="cpu"),
                                       probe_nonces=1 << 10)
    assert rate > 0
    with pytest.raises(RuntimeError):
        miner_mod.measure_rate_hint(_Raising())


def test_resolve_rate_hint(monkeypatch):
    """The hint from the environment; a probe's launches are not left in
    the miner's launch counts, which count the requests served."""
    from distributed_bitcoinminer_tpu_torch.ops import sha256_cuda

    class Fast:
        def search(self, lower, upper):
            sha256_cuda.launches["K1"] += 1     # as a launch would
            return 0, lower
    factory = lambda data: Fast()   # noqa: E731
    for raw, want in ((None, 0.0), ("0", 0.0), ("1234.5", 1234.5),
                      ("-5", 0.0), ("bad", 0.0)):
        if raw is None:
            monkeypatch.delenv("DBMT_RATE_HINT", raising=False)
        else:
            monkeypatch.setenv("DBMT_RATE_HINT", raw)
        assert miner_mod._resolve_rate_hint(factory) == want
    monkeypatch.setenv("DBMT_RATE_HINT", "probe")
    assert miner_mod._resolve_rate_hint(factory) > 0
    assert sha256_cuda.total_launches() == 0
    with pytest.raises(RuntimeError):
        miner_mod._resolve_rate_hint(lambda data: _Raising())


def test_join_carries_the_hint(monkeypatch):
    import asyncio

    class Client:
        def __init__(self):
            self.sent = []

        def write(self, payload):
            self.sent.append(Message.from_json(payload))

    async def fake_connect(hostport, params=None):
        return Client()
    monkeypatch.setattr(miner_mod, "new_async_client", fake_connect)
    for hint, wire in ((0.0, b'"Rate"'), (12345.6, b'"Rate":12345')):
        w = miner_mod.MinerWorker("127.0.0.1:1", rate_hint=hint)
        asyncio.run(w.join())
        (msg,) = w.client.sent
        assert msg.rate == int(hint)
        assert (wire in msg.to_json()) == bool(hint)
