"""The port's metrics plane against the JAX package's.

The scheduler's series (the miner plane's pool, lease, stripe, rate and
trust families, the QoS plane's tenant and shed families, the cache hit
ratio) are held to the JAX scheduler's by ``test_torch_sched.Pair``, whose
``check`` compares both registries' snapshots family by family after
every event; here the same harness drives the sequences the JAX package's
own metric tests script (a lease blow, a re-issue, a duplicate and a cache
replay; a miner's drop; reconnect churn under a small series bound;
tenant GC and ``forget``; the three shed reasons). Then a port
``MinerWorker`` on the CPU serves arg-min, difficulty and coalesced chunks
beside a JAX ``MinerWorker`` given the same searchers, and their
``miner.*`` deltas must be equal; the ``model.*`` deltas are held to the
JAX searcher's planning and, where the port counts by design otherwise
(``model.device_launches``, ``model.coalesced_launches``), to the port's
stated rule. Last, the rollup's process row of a port scheduler, and the
family lists of both packages' sources.
"""

import asyncio
import os
import re

from distributed_bitcoinminer_tpu.apps import rollup as ref_rollup
from distributed_bitcoinminer_tpu.apps.miner import \
    MinerWorker as RefMinerWorker
from distributed_bitcoinminer_tpu.models.miner_model import \
    NonceSearcher as RefNonceSearcher
from distributed_bitcoinminer_tpu.utils import metrics as ref_metrics
from distributed_bitcoinminer_tpu_torch.apps import rollup
from distributed_bitcoinminer_tpu_torch.apps.miner import MinerWorker
from distributed_bitcoinminer_tpu_torch.bitcoin.hash import hash_op
from distributed_bitcoinminer_tpu_torch.bitcoin.message import (Message,
                                                                new_request)
from distributed_bitcoinminer_tpu_torch.models.miner_model import \
    BATCH_ROWS_MAX
from distributed_bitcoinminer_tpu_torch.utils import metrics
from tests.test_torch_apps import cpu_factory
from tests.test_torch_batch import _ScriptClient
from tests.test_torch_lease import honest
from tests.test_torch_sched import (LEFT_OUT_FAMILIES, MINER_A, MINER_B,
                                    MINER_C, TEN_W, TEN_X, TEN_Y, TEN_Z,
                                    Pair, clock)

__all__ = ["clock"]   # the fake-clock fixture, shared with test_torch_sched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def gauges(p):
    return p.port.metrics.snapshot()["gauges"]


def both(p, fn):
    for s in (p.port, p.ref):
        fn(s)
    p.check()


# ------------------------------------------------------------ the scheduler

def test_scripted_fault_sequence_snapshot_equals_jax(clock):
    """The JAX package's scripted sequence: a lease blow, a re-issue, a
    duplicate and a cache replay land the same counters, gauges and
    histogram counts in both schedulers' registries, and the port's
    process registry shows them under ``sched.``."""
    p = Pair(clock, lease={"grace_s": 30.0, "quarantine_after": 1})
    for m in (MINER_A, MINER_B, MINER_C):
        p.join(m)
    p.request(TEN_X, "scripted", 299)                 # 3 chunks
    p.answer(MINER_C)
    both(p, lambda s: setattr(
        s.miner_plane.find_miner(MINER_A).pending[0], "deadline", 0.0))
    p.sweep()                          # A's lease blows: re-issued to C
    assert gauges(p)["pool_quarantined"] == 1
    p.answer(MINER_C)                  # the copy answers
    p.answer(MINER_A)                  # the original: a duplicate
    p.answer(MINER_B)                  # the barrier completes
    p.request(TEN_Y, "scripted", 299)  # answered from the cache
    snap = p.port.metrics.snapshot()
    c = snap["counters"]
    assert (c["results_sent"], c["leases_blown"], c["reissues"],
            c["dup_results"], c["quarantines"], c["cache_hits"],
            c["cache_misses"], c["cache_stores"]) == (2, 1, 1, 1, 1, 1, 1, 1)
    g = snap["gauges"]
    assert (g["pool_size"], g["pool_quarantined"], g["queue_depth"],
            g["cache_hit_ratio"], g["lease_min_remaining_s"]) == \
        (3, 0, 0, 0.5, 0.0)
    assert snap["histograms"]["lease_wait_s"]["count"] == 4
    assert snap["histograms"]["stripe_chunks_per_share"]["count"] == 3
    proc = metrics.registry().snapshot()
    assert proc["counters"]["sched.reissues"] == 1
    assert proc["gauges"]["sched.cache_hit_ratio"] == 0.5


def test_motivation_sequence_snapshots_equal(clock):
    """Three miners joining with a rate hint, an elephant of 10^7 nonces
    and a mouse, three answers: every family the JAX scheduler shows."""
    p = Pair(clock)
    for m in (MINER_A, MINER_B, MINER_C):
        p.join(m, rate=10 ** 6)
    p.request(TEN_X, "elephant", 10 ** 7)
    p.request(TEN_Y, "mouse", 999)
    for _ in range(3):
        clock.step(0.2)
        # A true pair (the chunk's first nonce), which the claim check
        # takes without a scan of the elephant's chunks.
        p.answer(p.busy()[0], pair=lambda c: (hash_op(c.data, c.lower),
                                              c.lower))
    snap = p.port.metrics.snapshot()
    for key in ("cache_hit_ratio", "lease_min_remaining_s",
                "miner_rate_nps{miner=101}", "pool_quarantined",
                "pool_rate_nps", "qos_grant_share{tenant=1}", "qos_tenants"):
        assert key in snap["gauges"], key
    assert "qos_granted_chunks{tenant=1}" in snap["counters"]
    assert {"lease_wait_s", "stripe_chunks_per_share"} <= \
        set(snap["histograms"])


def test_miner_drop_retires_its_labelled_series(clock):
    p = Pair(clock, verify={"trust_decay": 0.5})
    p.join(MINER_A, rate=5_000)
    p.join(MINER_B, rate=5_000)
    both(p, lambda s: s.miner_plane.set_chunk_s_override(MINER_A, 0.25))
    p.request(TEN_X, "drop", 99_999)
    p.sweep()
    c = p.head(MINER_A)
    p.answer(MINER_A, pair=lambda _c: (honest(c)[0] + 1, c.lower))
    a = str(MINER_A)
    series = [f"{family}{{miner={a}}}" for family in (
        "miner_rate_nps", "lease_remaining_s", "adapt_chunk_s_miner",
        "miner_trust")]
    assert all(k in gauges(p) for k in series[1:]), gauges(p)
    p.drop(MINER_A)
    g = gauges(p)
    assert not [k for k in series if k in g]
    assert f"miner_rate_nps{{miner={MINER_B}}}" in g and g["pool_size"] == 1


def test_reconnect_churn_stays_inside_the_series_bound(clock, monkeypatch):
    """Every rejoin is a fresh conn id; each drop retires its series, so
    a small ``max_series`` never overflows."""
    for name in ("DBMT_METRICS_MAX_SERIES", "DBM_METRICS_MAX_SERIES"):
        monkeypatch.setenv(name, "4")
    p = Pair(clock)
    live = []
    for conn in range(200, 230):
        p.join(conn, rate=1_000 + conn)
        live.append(conn)
        if len(live) == 3:
            p.drop(live.pop(0))
    snap = p.port.metrics.snapshot()
    assert snap["series_overflow"] == 0
    assert sorted(k for k in snap["gauges"] if k.startswith("miner_rate")) \
        == [f"miner_rate_nps{{miner={m}}}" for m in live]


def test_tenant_gc_and_forget_retire_the_qos_series(clock):
    """A grant sets the granted tenant's series; the sweep refreshes the
    others' shares; a dropped client's and an idle tenant's series
    retire."""
    p = Pair(clock)
    p.join(MINER_A)
    p.join(MINER_B)
    p.request(TEN_X, "gc x", 999)
    p.request(TEN_Y, "gc y", 2_999)
    p.request(TEN_X, "gc x again", 999)
    p.answer(MINER_A)
    p.answer(MINER_B)              # x answered, y granted
    share = f"qos_grant_share{{tenant={TEN_X}}}"
    g = gauges(p)
    assert (g["qos_tenants"], g[share],
            g[f"qos_grant_share{{tenant={TEN_Y}}}"]) == (2, 1.0, 0.75)
    p.sweep()                      # x's stale share refreshed
    assert gauges(p)[share] == 0.25
    p.drop(TEN_X)                  # forgotten with a request queued
    snap = p.port.metrics.snapshot()
    assert snap["gauges"]["qos_tenants"] == 1 and share not in snap["gauges"]
    assert f"qos_granted_chunks{{tenant={TEN_X}}}" not in snap["counters"]
    p.drain()
    p.sweep()                      # the idle tenant's GC
    snap = p.port.metrics.snapshot()
    assert snap["gauges"]["qos_tenants"] == 0
    assert not [k for k in list(snap["gauges"]) + list(snap["counters"])
                if "tenant=" in k]


def test_three_shed_reasons_are_counted(clock):
    """At admission (an empty bucket), its queued sibling with it
    (``conn``), and past the queue's bound (``overload``)."""
    p = Pair(clock, qos={"rate": 1e-4, "burst": 1.0, "max_queued": 2})
    p.request(TEN_X, "first", 99)      # no miner: everything queues
    p.request(TEN_X, "second", 99)     # shed at admission, first with it
    for t in (TEN_Y, TEN_Z, TEN_W):
        p.request(t, "queued", 99)     # the third overloads the queue
    c = p.port.metrics.snapshot()["counters"]
    assert [c[f"qos_shed_reason{{reason={r}}}"]
            for r in ("admission", "conn", "overload")] == [1, 1, 1]


def test_rollup_row_of_a_scheduler_process(clock):
    """A port scheduler's snapshot gives the rollup's process row its
    ``trust_min``, ``lease_min_s`` and ``nps``, equal to the JAX
    scheduler's row; an honest pool publishes no trust series (the JAX
    rule: the gauge is set where a score moves). Then the real process
    registry's row, once a miner has lied."""
    p = Pair(clock, verify={"trust_decay": 0.5})
    p.join(MINER_A, rate=4_000)
    p.join(MINER_B)
    p.request(TEN_X, "rollup", 99_999)
    p.sweep()

    def rows():
        out = []
        for s, mod, reg in ((p.port, rollup, metrics.Registry),
                            (p.ref, ref_rollup, ref_metrics.Registry)):
            proc = reg()
            proc.mount("sched", s.metrics)
            out.append(mod._proc_detail(proc.snapshot()))
        assert out[0] == out[1]
        return out[0]
    row = rows()
    assert "trust_min" not in row
    assert row["lease_min_s"] > 0 and row["nps"] == 4_000.0 * 0.98
    c = p.head(MINER_B)
    p.answer(MINER_B, pair=lambda _c: (honest(c)[0] + 1, c.lower))
    assert rows()["trust_min"] == 0.5
    # The process registry (the scheduler mounted under ``sched.``; its
    # ``nps`` is a miner's EWMA where this process served chunks).
    row = rollup._proc_detail(metrics.registry().snapshot())
    assert row["trust_min"] == 0.5 and row["lease_min_s"] > 0
    assert isinstance(row["nps"], float)


# ----------------------------------------------------- the miner and model

def _family_deltas(reg, before: dict, prefix: str) -> dict:
    """``{series: delta}`` of the counters and histogram counts under
    ``prefix`` since the snapshot ``before``."""
    snap = reg.snapshot()
    out = {}
    for key, v in snap["counters"].items():
        if key.startswith(prefix):
            out[key] = v - before["counters"].get(key, 0)
    for key, h in snap["histograms"].items():
        if key.startswith(prefix):
            old = before["histograms"].get(key, {"count": 0, "counts": None})
            out[key + ".count"] = h["count"] - old["count"]
            if key.endswith(("coalesce_width", "dispatch_queue_depth")):
                out[key + ".counts"] = [a - b for a, b in zip(
                    h["counts"], old["counts"] or [0] * len(h["counts"]))]
    return out


def _serve(worker_cls, payloads, expect, factory):
    """Run one miner worker over scripted Requests until ``expect``
    Results land or it closes; returns the Results."""
    async def scenario():
        worker = worker_cls("unused:0", searcher_factory=factory)
        worker.client = _ScriptClient(payloads)
        task = asyncio.create_task(worker.run())
        for _ in range(1_000):
            if len(worker.client.writes) >= expect or worker.client.closed:
                break
            await asyncio.sleep(0.01)
        task.cancel()
        return [Message.from_json(w) for w in worker.client.writes]
    return asyncio.run(scenario())


#: A solo arg-min chunk over a digit-class edge, a difficulty chunk, and
#: three arg-min chunks of two tail shapes (the 60-character message's
#: digits cross a block) that coalesce into one batched launch.
LONG = "x" * 60
CHUNKS = [("abc", 99_990, 100_010, 0), ("abc", 5_000, 5_999, 1 << 62),
          ("abc", 7_000, 7_499, 0), (LONG, 1_000, 1_199, 0),
          ("abc", 8_000, 8_099, 0)]


def test_miner_and_model_deltas_equal_jax():
    payloads = [new_request(d, lo, up, t).to_json()
                for d, lo, up, t in CHUNKS]
    ref_before = ref_metrics.registry().snapshot()
    ref_replies = _serve(RefMinerWorker, list(payloads), len(CHUNKS),
                         lambda data, batch: cpu_factory()(data))
    ref = _family_deltas(ref_metrics.registry(), ref_before, "miner.")
    before = metrics.registry().snapshot()
    replies = _serve(MinerWorker, list(payloads), len(CHUNKS),
                     cpu_factory())
    port = _family_deltas(metrics.registry(), before, "miner.")
    assert [(m.hash, m.nonce) for m in replies] == \
        [(m.hash, m.nonce) for m in ref_replies]
    assert port == ref
    assert port["miner.nonces_scanned"] == \
        sum(up - lo + 1 for _, lo, up, _ in CHUNKS)
    assert (port["miner.chunks_served"], port["miner.coalesced_dispatches"],
            port["miner.chunks_coalesced"], port["miner.chunks_two_phase"],
            port["miner.chunk_seconds.count"]) == (5, 1, 3, 4, 3)

    # The model: the JAX searchers' planning of the same chunks counts
    # the midstate cache and the blocks alike; the port counts a search
    # launch a block of a chain and a tail shape of a batched launch, and
    # one batched launch a BATCH_ROWS_MAX rows (the JAX package one a
    # jitted dispatch and a shape group).
    model = _family_deltas(metrics.registry(), before, "model.")
    ref_before = ref_metrics.registry().snapshot()
    searchers = {}
    plans = [list(searchers.setdefault(d, RefNonceSearcher(d, 1024)).plan(
        lo, up)) for d, lo, up, _ in CHUNKS]
    ref_model = _family_deltas(ref_metrics.registry(), ref_before, "model.")
    for key in ("model.midstate_cache{result=hit}",
                "model.midstate_cache{result=miss}",
                "model.blocks_dispatched"):
        assert model[key] == ref_model[key], key
    batched = plans[2:]
    rows = sum(len(p) for p in batched)
    shapes = {(b.rem, b.k, b.template.shape[0]) for p in batched for b in p}
    assert (model["model.coalesced_rows"], model["model.coalesced_launches"],
            model["model.device_launches"]) == \
        (rows, -(-rows // BATCH_ROWS_MAX),
         len(plans[0]) + len(plans[1]) + len(shapes))
    assert len(shapes) == 2


def test_search_failure_is_counted_before_the_miner_exits():
    class Broken:
        def search(self, lower, upper):
            raise RuntimeError("device lost")

    payloads = [new_request("broken", 0, 99).to_json()]
    for worker, reg, factory in (
            (MinerWorker, metrics.registry(), lambda data: Broken()),
            (RefMinerWorker, ref_metrics.registry(),
             lambda data, batch: Broken())):
        before = reg.snapshot()["counters"]["miner.search_failures"]
        assert _serve(worker, list(payloads), 1, factory) == []
        assert reg.snapshot()["counters"]["miner.search_failures"] == \
            before + 1


# ------------------------------------------------------------ the families

FAMILY = re.compile(r"\.(?:counter|gauge|histogram|ewma)\(\s*"
                    r"(?:#[^\n]*\n\s*)*\"([^\"]+)\"")


def _families(package: str) -> set:
    names = set()
    for root, _dirs, files in os.walk(os.path.join(REPO, package)):
        for f in files:
            path = os.path.join(root, f)
            if f.endswith(".py") and not path.endswith(
                    os.path.join("utils", "metrics.py")):
                with open(path, encoding="utf-8") as fh:
                    names |= set(FAMILY.findall(fh.read()))
    return names


def test_the_port_registers_every_jax_family_but_the_left_out():
    """The family names in both packages' sources: the JAX package's all
    registered by the port but the left-out ones, and the port's own the
    fresh-launch families that stand for the jit-compile ones and the
    process tier's per-kernel launch gauges of its CUDA kernels."""
    ref = _families("distributed_bitcoinminer_tpu")
    port = _families("distributed_bitcoinminer_tpu_torch")
    assert ref - port == set(LEFT_OUT_FAMILIES)
    assert port - ref == {"trace.fresh_launches", "trace.fresh_launch_worst_s",
                          "trace.launch_storms", "miner.kernel_launches"}
