"""The replica tier's in-process half against the JAX package's: the
hash ring, ``ReplicaSet``, the health plane, the state files and the
rollup.

``HashRing`` owners against the JAX ring's; the port's ``ReplicaSet``
and the JAX one fed the same transport items (joins, requests, Results,
drops, a replica's kill) over recording fake servers under one fake
clock, every feature on as in ``tests/test_torch_sched.py``: after every
event both have written the same messages and closed the same conns,
route tenants and miners to the same replicas, and each replica pair
holds the same state (its job ids in the replica's own range); the
shared cache replays across replicas; ``kill`` adopts the dead replica's
miners and serves its requests again exactly once; ``cluster_rollup``
sums the replicas' counters. ``SeqFreshness``, ``BeatMonitor``,
``Membership`` with fencing and ``router_tick`` against the JAX ones on
seeded beat streams; the state-file helpers and ``resolve_owner`` across
the packages; ``merge_snapshots``, ``aggregate``, ``gc_stale_blobs`` and
``hist_quantile`` against the JAX functions on the same blobs; and a
``DBMT_REPLICAS=2`` server serving two ``--device cpu`` miners end to
end.
"""

import json
import os
import random
import re
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from distributed_bitcoinminer_tpu.apps import health as ref_health
from distributed_bitcoinminer_tpu.apps import procs as ref_procs
from distributed_bitcoinminer_tpu.apps import rollup as ref_rollup
from distributed_bitcoinminer_tpu.apps.replicas import \
    HashRing as RefHashRing
from distributed_bitcoinminer_tpu.apps.replicas import \
    ReplicaSet as RefReplicaSet
from distributed_bitcoinminer_tpu.bitcoin.hash import scan_min, scan_until
from distributed_bitcoinminer_tpu.utils import config as ref_config
from distributed_bitcoinminer_tpu.utils.metrics import \
    Registry as RefRegistry
from distributed_bitcoinminer_tpu_torch.apps import health, procs, rollup
from distributed_bitcoinminer_tpu_torch.apps.replicas import (HashRing,
                                                              ReplicaSet)
from distributed_bitcoinminer_tpu_torch.apps.scheduler import STAT_COUNTERS
from distributed_bitcoinminer_tpu_torch.bitcoin.message import (new_join,
                                                                new_request,
                                                                new_result)
from distributed_bitcoinminer_tpu_torch.utils import config
from distributed_bitcoinminer_tpu_torch.utils.metrics import Registry
from distributed_bitcoinminer_tpu_torch.utils.metrics import \
    registry as process_registry
from tests.test_torch_lease import honest
from tests.test_torch_sched import FakeServer, Pair, clock  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRIDE = ReplicaSet.JOB_ID_STRIDE


def test_hash_ring_owners_equal_jax():
    for ids in ([0], [0, 1], [0, 1, 2], [1, 3, 7], list(range(8))):
        port, ref = HashRing(ids), RefHashRing(ids)
        for key in list(range(600)) + ["tenant", (1, 2)]:
            assert port.owner(key) == ref.owner(key)
    with pytest.raises(ValueError, match="empty ring"):
        HashRing([]).owner(1)
    assert ReplicaSet.JOB_ID_STRIDE == RefReplicaSet.JOB_ID_STRIDE


# ------------------------------------------------------- the replica sets


class Sets:
    """The port's ReplicaSet and the JAX one, ``n`` replicas each, with
    the settings of ``tests/test_torch_sched.py``'s ``Pair`` (the JAX
    defaults, every feature on)."""

    def __init__(self, clock, n=2, qos=None, cache=None, lease=None):
        self.port_server, self.ref_server = FakeServer(), FakeServer()
        qos = qos or {}
        self.port = ReplicaSet(
            self.port_server, n, qos=config.QosParams(**{"lazy": True,
                                                         **qos}),
            coalesce=config.CoalesceParams(),
            lease=config.LeaseParams(**(lease or {})),
            verify=config.VerifyParams(audit_p=0.0),
            stripe=config.StripeParams(),
            cache=config.CacheParams(**(cache or {})),
            adapt=config.AdaptParams(admit=True))
        self.ref = RefReplicaSet(
            self.ref_server, n, qos=ref_config.QosParams(**qos),
            coalesce=ref_config.CoalesceParams(),
            lease=ref_config.LeaseParams(**(lease or {})),
            verify=ref_config.VerifyParams(audit_p=0.0),
            stripe=ref_config.StripeParams(),
            cache=ref_config.CacheParams(**(cache or {})),
            adapt=ref_config.AdaptParams(), clock=clock.monotonic)

    def route(self, conn, payload):
        for s in (self.port, self.ref):
            s.route(conn, payload)
        self.check()

    def join(self, conn):
        self.route(conn, new_join().to_json())

    def request(self, conn, data, max_nonce, target=0):
        self.route(conn, new_request(data, 0, max_nonce, target).to_json())

    def drop(self, conn):
        for s in (self.port, self.ref):
            s.route(conn, ConnectionError("gone"))
        self.check()

    def kill(self, rid):
        for s in (self.port, self.ref):
            s.kill(rid)
        self.check()

    def owner(self, miner):
        return self.port.replicas[self.port._miner_owner[miner]]

    def answer(self, miner):
        chunk = self.owner(miner).miner_plane.find_miner(miner).pending[0]
        h, nonce = honest(chunk)
        self.route(miner, new_result(h, nonce, chunk.target).to_json())

    def busy(self):
        return sorted(m for m in self.port._miner_owner
                      if self.owner(m).miner_plane.find_miner(m).pending)

    def drain(self):
        while self.busy():
            self.answer(self.busy()[0])

    def replies(self, conn):
        return [(w[5], w[6]) for w in self.port_server.writes
                if w[0] == conn and w[1] == 2]

    def check(self):
        assert self.port_server.writes == self.ref_server.writes
        assert self.port_server.closed == self.ref_server.closed
        assert self.port.live == self.ref.live
        assert self.port._miner_owner == self.ref._miner_owner
        assert self.port._tenant_owner == self.ref._tenant_owner
        for rid in self.port.replicas:
            port, ref = self.port.replicas[rid], self.ref.replicas[rid]
            for name in STAT_COUNTERS:
                assert port.stats[name] == ref.stats[name], (rid, name)
            assert Pair.state(port) == Pair.state(ref), rid
            assert port._next_job_id == ref._next_job_id
            assert rid * STRIDE <= port._next_job_id < (rid + 1) * STRIDE
        assert self.port.stats == {k: self.ref.stats[k]
                                   for k in STAT_COUNTERS}


def test_routing_slices_and_shared_cache_equal_jax(clock):
    s = Sets(clock)
    for miner in (101, 102, 103):
        s.join(miner)
    assert s.port._miner_owner == {101: 0, 102: 1, 103: 0}
    tenants = list(range(1, 9))
    for t in tenants:
        s.request(t, f"tenant {t}", 2_000 + 37 * t)
    s.drain()
    owners = {s.port._tenant_owner[t] for t in tenants}
    assert owners == {0, 1}           # both replicas served tenants
    for t in tenants:
        assert s.replies(t) == [scan_min(f"tenant {t}", 0, 2_001 + 37 * t)]
    for rid in (0, 1):
        assert s.port.replicas[rid].stats["results_sent"] > 0
    # A request answered on one replica replays from the shared cache on
    # the other (tenant 9 is owned by the other replica than tenant 1's).
    other = next(t for t in range(9, 40)
                 if s.port.ring.owner(t) != s.port._tenant_owner[1])
    written = len(s.port_server.writes)
    s.request(other, "tenant 1", 2_037)
    assert len(s.port_server.writes) == written + 1
    assert s.replies(other) == s.replies(1)
    roll = s.port.cluster_rollup()
    assert roll["sources"] == 2
    assert roll["counters"]["results_sent"] == \
        s.port.stats["results_sent"] == len(tenants) + 1
    # Each replica's series reach the process registry (the metrics
    # emitter's) under a prefix of its own.
    snap = process_registry().snapshot()["counters"]
    assert snap["sched.r0.results_sent"] + snap["sched.r1.results_sent"] \
        == len(tenants) + 1
    ref_roll = s.ref.cluster_rollup()
    for name in STAT_COUNTERS:
        assert roll["counters"].get(name, 0) == \
            ref_roll["counters"].get(name, 0), name


def test_kill_adopts_miners_and_reserves_exactly_once(clock):
    s = Sets(clock, qos={"wholesale_s": 1e9})
    for miner in (101, 102, 103, 104):
        s.join(miner)
    for t in range(1, 7):
        s.request(t, f"kill {t}", 3_000 + t, (1 << 60) if t == 4 else 0)
    s.answer(101)
    dead = 0
    dead_jobs = set(s.port.replicas[dead]._inflight)
    assert dead_jobs and all(j < STRIDE for j in dead_jobs)
    s.kill(dead)
    assert s.port.live == [1]
    assert set(s.port._miner_owner.values()) == {1}
    survivor = s.port.replicas[1]
    assert len(survivor.miners) == 4
    s.drain()
    for t in range(1, 7):
        target = (1 << 60) if t == 4 else 0
        want = scan_until(f"kill {t}", 0, 3_001 + t, target)[:2]
        assert s.replies(t) == [want], t
    with pytest.raises(ValueError, match="not live"):
        s.port.kill(dead)
    with pytest.raises(ValueError, match="last live replica"):
        s.port.kill(1)


def _views(rs):
    """The merged views the interleaving explorer's invariants read."""
    return (sorted(rs._inflight), sorted(r.job_id for r in rs.queue),
            sorted((t, st.inflight) for t, st in rs.qos_plane.tenants.items()),
            sorted(k for k, _t in rs.traces.items()))


def test_merged_views_equal_jax(clock):
    """``ReplicaSet.queue``, ``_inflight``, ``qos_plane`` (``_MergedQos``)
    and ``traces`` over the live replicas equal the JAX set's, before and
    after a replica's kill; ``Scheduler.queue`` is the tenant plane's
    queue, in arrival order."""
    s = Sets(clock, qos={"wholesale_s": 1e-9, "chunk_s": 4.0})
    for miner in (101, 102):
        s.join(miner)
    for rid in s.port.replicas:
        for rs in (s.port, s.ref):
            rs.replicas[rid].miner_plane.pin_rates(1000.0)
    for t in range(1, 9):
        s.request(t, f"view {t}", 20_000 + t)
    views = _views(s.port)
    assert views == _views(s.ref)
    inflight, queued, tenants, traces = views
    assert inflight and queued and traces
    assert any(n for _t, n in tenants)      # granted chunks accounted
    for rid, sched in s.port.replicas.items():
        assert [r.job_id for r in sched.queue] == \
            [r.job_id for r in sched.tenant_plane.requests()]
        assert [r.job_id for r in sched.queue] == \
            [r.job_id for r in s.ref.replicas[rid].queue]
    s.kill(0)
    assert _views(s.port) == _views(s.ref)
    assert all(j >= STRIDE for j in s.port._inflight)
    s.drain()
    assert _views(s.port)[:2] == ([], []) == _views(s.ref)[:2]
    assert all(n == 0 for _t, n in s.port.qos_plane.tenants.items()
               for n in [n.inflight])


def test_pin_rates_equals_jax(clock):
    """``MinerPlane.pin_rates`` warms the un-hinted miners and the pool as
    the JAX helper does, keeping a hinted miner's JOIN hint."""
    pair = Pair(clock)
    pair.join(101, rate=50_000)
    pair.join(102)
    for include in (False, True):
        for sched in (pair.port, pair.ref):
            sched.miner_plane.pin_rates(1234.0, include_hinted=include)
        mine = [(m.rate_ewma, m.rate_hinted) for m in pair.port.miners]
        assert mine == [(m.rate_ewma, m.rate_hinted) for m in pair.ref.miners]
        assert pair.port.miner_plane.pool_rate == \
            pair.ref.miner_plane.pool_rate == 1234.0
        assert pair.port.miner_plane._pool_hinted is False
    assert [m.rate_ewma for m in pair.port.miners] == [1234.0, 1234.0]


def test_requests_before_any_miner_and_drops_equal_jax(clock):
    s = Sets(clock, n=3, cache={"size": 4})
    s.request(1, "early", 999)
    s.request(2, "early two", 999)
    s.join(101)
    s.join(102)
    s.request(3, "later", 4_999)
    s.drop(2)
    s.answer(101)
    s.drop(102)
    s.join(103)
    s.drain()
    assert s.replies(1) == [scan_min("early", 0, 1_000)]
    assert s.replies(3) == [scan_min("later", 0, 5_000)]


def test_reserve_request_bypasses_admission_like_jax(clock):
    """A re-served request spends no admission token and sheds no queued
    one, with the adapt plane's congestion bound mounted too; the queue
    bound holds again at the next arrival."""
    p = Pair(clock, qos={"rate": 0.01, "burst": 1.0, "max_queued": 1})
    p.join(101)
    p.request(1, "first", 999)                    # spends the token
    for i in range(3):
        p.both(lambda s, i=i: s.reserve_request(
            1, new_request(f"re-served {i}", 0, 99)))
    assert p.port.stats["qos_shed"] == 0
    assert len(p.port.tenant_plane) == 3
    p.request(2, "arrival", 9)
    assert p.port.stats["qos_shed"] == 3          # the oldest, down to 1
    p.drain()


# ---------------------------------------------------------------- health


def _beat(mod, rid, inc, seq, **kw):
    return mod.Beat(rid=rid, incarnation=inc, seq=seq, **kw)


def test_health_plane_equals_jax_on_seeded_beats():
    rng = np.random.default_rng(12)
    port = health.RouterState(health.BeatMonitor(0.5, 3))
    ref = ref_health.RouterState(ref_health.BeatMonitor(0.5, 3))
    fresh, ref_fresh = health.SeqFreshness(1.5), ref_health.SeqFreshness(1.5)
    seqs, incs = {r: 0 for r in range(4)}, {r: "a" for r in range(4)}
    now = 0.0
    for step in range(300):
        now += float(rng.choice([0.1, 0.5, 0.9]))
        beats = []
        for rid in range(4):
            x = rng.random()
            if x < 0.05:
                incs[rid] = f"inc{step}"          # a restart
                seqs[rid] = 0
            if x < 0.7:
                seqs[rid] += 1                    # else a frozen seq
            beats.append((rid, incs[rid], seqs[rid],
                          bool(rng.random() < 0.95), int(rng.integers(3))))
        changed = health.router_tick(port, [
            _beat(health, r, i, q, serving=sv, miners=m, port=7000 + r)
            for r, i, q, sv, m in beats], now)
        assert changed == ref_health.router_tick(ref, [
            _beat(ref_health, r, i, q, serving=sv, miners=m, port=7000 + r)
            for r, i, q, sv, m in beats], now)
        assert port.membership.to_dict() == ref.membership.to_dict()
        assert port.monitor.dead(now) == ref.monitor.dead(now)
        for r, i, q, *_ in beats:
            assert fresh.observe(r, i, q, now) == \
                ref_fresh.observe(r, i, q, now)
        assert fresh.stale(now) == ref_fresh.stale(now)
        assert fresh.age_s(0, now) == ref_fresh.age_s(0, now)
    assert port.membership.epoch > 10 and port.membership.fenced


def test_membership_fencing_equals_jax():
    for mod in (health, ref_health):
        m = mod.Membership()
        a1 = mod.Beat(rid=1, incarnation="a1", seq=1, port=7001)
        assert m.admit(a1) and m.epoch == 1
        assert not m.admit(a1)                      # nothing changed
        assert m.declare_dead(1) and m.epoch == 2
        assert m.is_fenced(1, "a1") and m.writer_fenced(1, "a1")
        assert not m.admit(a1)                      # the fence holds
        assert m.admit(mod.Beat(rid=1, incarnation="a2", seq=1, port=7002))
        assert not m.is_fenced(1, "a2") and not m.declare_dead(5)
    port, ref = health.Membership(), ref_health.Membership()
    for mod, mem in ((health, port), (ref_health, ref)):
        mem.admit(mod.Beat(rid=0, incarnation="x", seq=3, port=7000))
        mem.admit(mod.Beat(rid=2, incarnation="y", seq=1, port=7002))
        mem.declare_dead(0)
    assert port.to_dict() == ref.to_dict()
    assert health.Membership.from_dict(ref.to_dict()).to_dict() == \
        ref.to_dict()
    b = health.Beat(rid=3, incarnation="z", seq=9, miners=2)
    assert ref_health.Beat.from_dict(b.to_dict()) == \
        ref_health.Beat(**b.to_dict())


def test_state_files_and_resolve_owner_across_packages(tmp_path):
    d = str(tmp_path)
    assert procs.read_membership(d) is None
    assert procs.resolve_owner(d, 1) is None
    m = health.Membership()
    beats = [health.Beat(rid=r, incarnation=f"i{r}", seq=1, port=7000 + r,
                         miners=r % 2) for r in range(4)]
    for b in beats:
        m.admit(b)
    procs.write_json_atomic(procs.membership_path(d), m.to_dict())
    for b in beats[:3]:
        ref_procs.write_json_atomic(ref_procs.beat_path(d, b.rid),
                                    b.to_dict())
    with open(os.path.join(d, "beat_9.json"), "w") as fh:
        fh.write('{"rid": 9, "torn')
    assert procs.beat_path(d, 2) == ref_procs.beat_path(d, 2)
    assert procs.membership_path(d) == ref_procs.membership_path(d)
    assert procs.read_json(procs.membership_path(d)) == m.to_dict()
    assert sorted(b.to_dict()["rid"] for b in procs.read_beats(d)) == \
        [0, 1, 2]
    assert procs.read_membership(d).to_dict() == \
        ref_procs.read_membership(d).to_dict()
    # Serving = live with a miner in its current beat: only rid 1 here.
    for key in range(200):
        assert procs.resolve_owner(d, key) == \
            ref_procs.resolve_owner(d, key) == (1, "127.0.0.1:7001")
    procs.write_json_atomic(procs.beat_path(d, 3), beats[3].to_dict())
    procs.write_json_atomic(procs.beat_path(d, 1),
                            {**beats[1].to_dict(), "miners": 0})
    owners = {procs.resolve_owner(d, k) for k in range(200)}
    assert owners == {(3, "127.0.0.1:7003")}
    assert [procs.resolve_owner(d, k) for k in range(200)] == \
        [ref_procs.resolve_owner(d, k) for k in range(200)]
    assert not [n for n in os.listdir(d) if ".tmp." in n]


# ---------------------------------------------------------------- rollup


def _registries(registry_cls, seed):
    rng = random.Random(seed)
    regs = []
    for i in range(3):
        r = registry_cls(max_series=8)
        r.counter("sched.results_sent").inc(rng.randint(1, 50))
        r.counter("sched.qos_shed", tenant=str(i % 2)).inc(rng.randint(0, 9))
        r.gauge("sched.queue_depth").set(rng.randint(0, 30))
        r.gauge("sched.miner_trust", miner=str(i)).set(rng.random())
        h = r.histogram("sched.queue_wait_s")
        for _ in range(rng.randint(1, 40)):
            h.observe(rng.random() * 3)
        e = r.ewma("miner.nonces_per_s")
        for _ in range(rng.randint(1, 5)):
            e.observe(rng.random() * 1e9)
        if i == 2:
            r.histogram("odd", buckets=(1.0, 2.0)).observe(1.5)
        regs.append(r)
    return regs


def test_merge_snapshots_equals_jax():
    """The same snapshots (the port's registries' and the JAX ones',
    which must have the same shape) through both merges."""
    for seed in range(5):
        snaps = [(f"p{i}", r.snapshot())
                 for i, r in enumerate(_registries(Registry, seed))]
        ref_shape = [(f"p{i}", r.snapshot())
                     for i, r in enumerate(_registries(RefRegistry, seed))]
        for (_, a), (_, b) in zip(snaps, ref_shape):
            for kind in ("counters", "gauges", "histograms", "ewmas"):
                assert sorted(a[kind]) == sorted(b[kind])
        snaps[2][1]["histograms"]["odd"] = {"le": [9.0], "counts": [1],
                                            "count": 1, "sum": 1.0}
        for bound in (None, 1):
            got = rollup.merge_snapshots(snaps, rollup.SourceSet(bound))
            want = ref_rollup.merge_snapshots(snaps,
                                              ref_rollup.SourceSet(bound))
            assert json.dumps(got, sort_keys=True) == \
                json.dumps(want, sort_keys=True)
        h = got["histograms"]["sched.queue_wait_s"]
        for q in (0.0, 0.5, 0.99, 1.0):
            assert rollup.hist_quantile(h, q) == \
                ref_rollup.hist_quantile(h, q)
    assert rollup.hist_quantile(None, 0.5) is None


def test_aggregate_and_gc_equal_jax(tmp_path, monkeypatch):
    d = str(tmp_path / "state")
    os.mkdir(d)
    regs = _registries(Registry, 7)
    t0 = 1_000_000.0
    monkeypatch.setattr(rollup.time, "time", lambda: t0)
    for rid, reg in enumerate(regs):
        rollup.RollupPublisher(d, "replica", rid, f"inc{rid}", registry=reg,
                               beat_s=0.5).publish(epoch_seen=rid)
    ref_rollup.RollupPublisher(d, "miner", 9, "m9",
                               registry=_registries(RefRegistry, 8)[0],
                               beat_s=0.5).publish()
    stale = rollup.RollupPublisher(d, "miner", 4, "m4", registry=regs[0],
                                   beat_s=0.5)
    stale.publish()
    doc = rollup.read_blobs(d)
    assert [(b["role"], b["rid"]) for b in doc] == \
        [(b["role"], b["rid"]) for b in ref_rollup.read_blobs(d)]
    m = health.Membership()
    m.admit(health.Beat(rid=1, incarnation="inc1", seq=1))
    m.declare_dead(1)
    procs.write_json_atomic(procs.membership_path(d), m.to_dict())
    # Age one blob past its window.
    path = rollup.blob_path(d, "miner", 4)
    blob = procs.read_json(path)
    procs.write_json_atomic(path, {**blob, "wall": t0 - 60})
    for now in (t0 + 0.1, t0 + 2.0):
        got = rollup.aggregate(d, now=now)
        want = ref_rollup.aggregate(d, now=now)
        assert json.dumps(got, sort_keys=True) == \
            json.dumps(want, sort_keys=True)
    # Windows of 0.5 s x 3: at t0 + 2 every blob is stale, replica 1's
    # incarnation fenced.
    status = {p["proc"]: p["status"] for p in got["procs"]}
    assert status == {"miner4": "stale", "miner9": "stale",
                      "replica0": "stale", "replica1": "fenced",
                      "replica2": "stale"}
    got = rollup.aggregate(d, now=t0 + 0.1)
    status = {p["proc"]: p["status"] for p in got["procs"]}
    assert status == {"miner4": "stale", "miner9": "fresh",
                      "replica0": "fresh", "replica1": "fenced",
                      "replica2": "fresh"}
    assert got["cluster"]["counters"]["sched.results_sent"] == sum(
        r.snapshot()["counters"]["sched.results_sent"]
        for r in (regs[0], regs[2])) + _registries(
            RefRegistry, 8)[0].snapshot()["counters"]["sched.results_sent"]
    # The GC past 20 windows (30 s), each package on its own copy.
    d2 = str(tmp_path / "copy")
    shutil.copytree(d, d2)
    for now, removed in ((t0 + 10, 1), (t0 + 31, 4)):
        assert rollup.gc_stale_blobs(d, now=now) == \
            ref_rollup.gc_stale_blobs(d2, now=now) == removed
        assert sorted(os.listdir(d)) == sorted(os.listdir(d2))
    assert rollup.read_blobs(d) == []


@pytest.mark.parametrize("env", [
    {}, {"REPLICAS": "3", "HEALTH_BEAT_S": "0.2", "HEALTH_MISS_K": "5",
         "ROLLUP": "0"},
    {"REPLICAS": "0", "HEALTH_BEAT_S": "junk", "ROLLUP_STALE_K": "7"},
    {"HEALTH_MISS_K": "4"}])
def test_replica_health_rollup_readers_equal_jax(monkeypatch, env):
    from distributed_bitcoinminer_tpu.apps import replicas as ref_replicas
    for k, v in env.items():
        monkeypatch.setenv(f"DBMT_{k}", v)
        monkeypatch.setenv(f"DBM_{k}", v)
    assert config.replicas_from_env() == ref_replicas.replicas_from_env()
    # The process tier reads the heartbeat and rollup knobs where it
    # passes them on (``apps.procs``, ``apps.rollup``), as the JAX
    # package's does; the parameters' defaults are the JAX readers' with
    # nothing set.
    assert procs.health_beat_s() == ref_procs.health_beat_s()
    assert procs.health_miss_k() == ref_procs.health_miss_k()
    assert rollup.rollup_enabled() == ref_rollup.rollup_enabled()
    assert rollup.stale_k() == ref_rollup.stale_k()
    for k in ("HEALTH_BEAT_S", "HEALTH_MISS_K", "ROLLUP_STALE_K"):
        monkeypatch.delenv(f"DBM_{k}", raising=False)
    assert rollup.BEAT_S == ref_procs.health_beat_s()
    assert rollup.STALE_K == ref_procs.health_miss_k() == \
        ref_rollup.stale_k()
    assert not hasattr(config, "health_beat_s")


# ------------------------------------------------------------ end to end


def _read(path) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()
    except FileNotFoundError:
        return ""


def test_two_replica_server_serves_cpu_miners(tmp_path):
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=REPO, DBMT_EPOCH_MILLIS="200",
               DBMT_EPOCH_LIMIT="20", DBMT_WINDOW="5", DBMT_REPLICAS="2")
    apps = "distributed_bitcoinminer_tpu_torch.apps"
    procs_ = [subprocess.Popen(
        [sys.executable, "-m", f"{apps}.{args[0]}", *args[1:]], env=env,
        cwd=str(tmp_path), stdout=open(tmp_path / f"{name}.out", "w"),
        stderr=subprocess.STDOUT)
        for name, args in (("server", ("server", str(port))),
                           ("m1", ("miner", f"127.0.0.1:{port}", "--device",
                                   "cpu")),
                           ("m2", ("miner", f"127.0.0.1:{port}", "--device",
                                   "cpu")))]
    clients = r"""
import asyncio, json, sys
sys.path.insert(0, sys.argv[1])
from distributed_bitcoinminer_tpu_torch.apps.client import submit
async def main():
    return await asyncio.gather(*(submit(sys.argv[2], f"replica {i}",
                                          3_000 + i) for i in range(8)))
print(json.dumps(asyncio.run(asyncio.wait_for(main(), 60))))
"""
    try:
        deadline = time.monotonic() + 60
        while _read(tmp_path / "log.txt").count(" joined") < 2:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        out = subprocess.run([sys.executable, "-c", clients, REPO,
                              f"127.0.0.1:{port}"], env=env,
                             capture_output=True, text=True, timeout=90)
        assert out.returncode == 0, out.stderr[-2000:]
        got = json.loads(out.stdout.strip().splitlines()[-1])
        assert got == [list(scan_min(f"replica {i}", 0, 3_001 + i))
                       for i in range(8)]
        jobs = [int(j) for j in re.findall(r"request (\d+) served in ",
                                            _read(tmp_path / "log.txt"))]
        assert len(jobs) == 8
        assert {j // STRIDE for j in jobs} == {0, 1}   # both replicas
    finally:
        for p in procs_:
            p.kill()
            p.wait()
