"""The SLO tracker, the console's rollup state and ``dbmtop`` against the
JAX package's.

``SloTracker`` of both packages fed the same seeded sequence of rollup
documents at a fixed clock, with the ``DBMT_SLO_*`` knobs and their
``DBM_SLO_*`` twins set alike: equal ``status()`` after every document,
equal alerts, equal flight-recorder events. ``RollupState.refresh()`` of
both over one state directory (blobs published by both packages, a
frozen publisher, a replayed blob, a fenced replica, a membership whose
epoch moves): equal documents and epoch timelines. The port's
``tools/dbmtop.one_doc`` and ``render`` equal the JAX
``scripts/dbmtop.py``'s on the same directory and clock.
"""

import importlib.util
import os
import random
import types

import pytest

from distributed_bitcoinminer_tpu.apps import procs as ref_procs
from distributed_bitcoinminer_tpu.apps import rollup as ref_rollup
from distributed_bitcoinminer_tpu.apps import slo as ref_slo
from distributed_bitcoinminer_tpu.utils.metrics import \
    Registry as RefRegistry
from distributed_bitcoinminer_tpu_torch.apps import health, procs, rollup, slo
from distributed_bitcoinminer_tpu_torch.tools import dbmtop
from distributed_bitcoinminer_tpu_torch.utils.metrics import Registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LE = [0.001, 0.01, 0.1, 1.0, 10.0, 60.0, 120.0]


def _ref_dbmtop():
    spec = importlib.util.spec_from_file_location(
        "ref_dbmtop", os.path.join(REPO, "scripts", "dbmtop.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Recorder:
    def __init__(self):
        self.events = []

    def record(self, event, **detail):
        self.events.append((event, detail))


def _docs(seed, n=60):
    """Rollup documents with cumulative counters: healthy stretches, a
    shedding storm, slow queue waits, then recovery; two replicas' rows."""
    rng = random.Random(seed)
    sent = shed = grants = 0
    waits = [0] * len(LE)
    docs = []
    for i in range(n):
        storm = 20 <= i < 35
        slow = 30 <= i < 45
        k = rng.randint(1, 9)
        sent += k
        grants += k + rng.randint(0, 3)
        shed += rng.randint(3, 12) if storm else rng.randint(0, 1)
        for _ in range(k):
            w = rng.random() * (90.0 if slow else 0.5)
            for j, le in enumerate(LE):
                if w <= le:
                    waits[j] += 1
        count = waits[-1] + (rng.randint(0, 2) if slow else 0)
        procs_rows = [
            {"proc": f"replica{r}", "status": "fenced" if (r, i >= 50)
             == (1, True) else "fresh",
             "detail": {"results": sent // (r + 1), "shed": shed // (2 - r),
                        "queue_wait_p99_s": 80.0 if slow and r else 0.2}}
            for r in (0, 1)]
        docs.append((1000.0 + 7.5 * i, {
            "at": 1000.0 + 7.5 * i, "procs": procs_rows,
            "cluster": {
                "counters": {"sched.results_sent": sent,
                             "sched.qos_shed{tenant=1}": shed,
                             "sched.qos_grants": grants},
                "histograms": {"sched.queue_wait_s": {
                    "le": LE, "counts": list(waits), "count": count,
                    "sum": 1.0}}}}))
    return docs


@pytest.mark.parametrize("seed,env", [
    (1, {}), (2, {"AVAIL": "0.999", "P99_S": "5", "BURN": "2"}),
    (3, {"SHED": "0.05", "WINDOW_S": "60"}),
    (4, {"AVAIL": "junk", "WINDOW_S": "0.1", "BURN": "0.5"})])
def test_slo_tracker_equals_jax(monkeypatch, seed, env):
    for k, v in env.items():
        monkeypatch.setenv(f"DBMT_SLO_{k}", v)
        monkeypatch.setenv(f"DBM_SLO_{k}", v)
    port_rec, ref_rec = Recorder(), Recorder()
    port = slo.SloTracker(recorder=port_rec)
    ref = ref_slo.SloTracker(recorder=ref_rec)
    assert (port.window_s, port.short_s, port.burn) == \
        (ref.window_s, ref.short_s, ref.burn)
    assert [(o.name, o.budget, o.describe) for o in port.objectives] == \
        [(o.name, o.budget, o.describe) for o in ref.objectives]
    fired = 0
    for now, doc in _docs(seed):
        got = port.observe(doc, now=now)
        assert got == ref.observe(doc, now=now)
        assert port.status() == ref.status()
        fired += len(got)
    assert port_rec.events == ref_rec.events
    assert len(port_rec.events) == fired
    if not env:
        assert fired >= 1


def test_slo_alert_reaches_the_flight_recorder():
    from distributed_bitcoinminer_tpu_torch.utils import trace
    rec = trace.flight_recorder()
    tracker = slo.SloTracker(burn=1.0)
    before = sum(1 for e in rec.events() if e["event"] == "slo_burn")
    fired = [a for now, doc in _docs(5) for a in tracker.observe(doc, now)]
    assert fired
    burns = [e for e in rec.events() if e["event"] == "slo_burn"]
    assert len(burns) - before == len(fired)
    assert burns[-1]["objective"] == fired[-1]["objective"]


# ------------------------------------------------------- the rollup state


def _registry(cls, seed):
    rng = random.Random(seed)
    r = cls(max_series=16)
    r.counter("sched.results_sent").inc(rng.randint(1, 50))
    r.counter("sched.qos_shed", tenant="1").inc(rng.randint(0, 9))
    r.counter("sched.qos_grants").inc(rng.randint(50, 90))
    r.gauge("sched.queue_depth").set(rng.randint(0, 30))
    r.gauge("sched.pool_size").set(rng.randint(1, 4))
    h = r.histogram("sched.queue_wait_s")
    for _ in range(rng.randint(1, 40)):
        h.observe(rng.random() * 3)
    r.ewma("miner.nonces_per_s").observe(rng.random() * 1e9)
    return r


class _Dir:
    """One state directory, written by both packages' publishers."""

    def __init__(self, d, clock):
        self.d = d
        self.clock = clock
        self.m = health.Membership()
        self.pubs = []
        for i, (pkg, cls, role, rid) in enumerate([
                (rollup, Registry, "replica", 0),
                (ref_rollup, RefRegistry, "replica", 1),
                (rollup, Registry, "router", 0),
                (ref_rollup, RefRegistry, "miner", 4242),
                (rollup, Registry, "gateway", 4343)]):
            inc = f"inc{i}"
            self.pubs.append(pkg.RollupPublisher(
                d, role, rid, inc, registry=_registry(cls, i),
                beat_s=0.5))
            if role == "replica":
                self.m.admit(health.Beat(rid=rid, incarnation=inc, seq=1))
        self.write_membership()

    def write_membership(self):
        procs.write_json_atomic(procs.membership_path(self.d),
                                self.m.to_dict())

    def publish(self, skip=()):
        for i, p in enumerate(self.pubs):
            if i not in skip:
                p.publish(epoch_seen=self.m.epoch)


@pytest.fixture
def fixed_time(monkeypatch):
    """One wall clock for both packages' rollup (publishers' stamps, the
    console's frames)."""
    clock = [5000.0]
    fake = types.SimpleNamespace(time=lambda: clock[0],
                                 monotonic=lambda: clock[0])
    for mod in (rollup, ref_rollup):
        monkeypatch.setattr(mod, "time", fake)
    return clock


def test_rollup_state_refresh_equals_jax(tmp_path, fixed_time):
    d = str(tmp_path)
    state = _Dir(d, fixed_time)
    port, ref = rollup.RollupState(d), ref_rollup.RollupState(d)
    frames = []
    for step in range(14):
        fixed_time[0] += 0.5
        # The miner freezes from step 4 on (its blob keeps its stamp and
        # seq); replica 1 is declared dead at step 6; from step 9 the
        # gateway's blob is replayed with a fresh stamp and an old seq.
        skip = {3} if step >= 4 else set()
        if step >= 9:
            skip.add(4)
            blob = ref_procs.read_json(state.pubs[4].path)
            blob["wall"] = fixed_time[0]
            procs.write_json_atomic(state.pubs[4].path, blob)
        if step == 6:
            state.m.declare_dead(1)
            state.write_membership()
        state.publish(skip)
        got, want = port.refresh(), ref.refresh()
        assert got == want
        assert port.epochs() == ref.epochs()
        frames.append({p["proc"]: p["status"] for p in got["procs"]})
    assert frames[0]["miner4242"] == "fresh"
    assert frames[-1]["miner4242"] == "stale"
    assert frames[-1]["replica1"] == "fenced"
    assert frames[-1]["gateway4343"] == "stale"
    assert [e for _, e in port.epochs()] == [2, 3]


def test_dbmtop_one_doc_equals_the_jax_console(tmp_path, fixed_time):
    ref_top = _ref_dbmtop()
    d = str(tmp_path)
    state = _Dir(d, fixed_time)
    port_state, ref_state = rollup.RollupState(d), ref_rollup.RollupState(d)
    port_slo, ref_slo_t = slo.SloTracker(), ref_slo.SloTracker()
    for step in range(6):
        fixed_time[0] += 0.5
        if step == 3:
            state.m.declare_dead(0)
            state.write_membership()
        state.publish()
        got = dbmtop.one_doc(d, port_state, port_slo)
        want = ref_top.one_doc(d, ref_state, ref_slo_t)
        assert got == want
        assert dbmtop.render(got) == ref_top.render(want)
    assert len(got["slo"]) == 3
    assert dbmtop.main(["--once", "--json", d]) == 0
    assert dbmtop.main([str(tmp_path / "missing")]) == 2
