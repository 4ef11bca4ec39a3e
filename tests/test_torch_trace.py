"""The port's tracing plane against the JAX package's ``utils/trace.py``.

From seeded numpy inputs: ``to_chrome_trace`` on stitched trace dicts,
``slow_phase`` on spans (malformed ones too), ``sample_hit``, the flight
recorder's ring and its dump, ``TrackSet`` under churn and its bound, and
the launch observer's bookkeeping and storm alarm against the JAX
compile observer, each equal to the JAX function's as JSON. A Result
with and without a span is byte for byte the JAX ``bitcoin/message.py``
encoding. Then the pieces the port wires up: the miner's chunk spans
(the pipelined executor with a coalesced window, a lone chunk, a
difficulty chunk; ``DBMT_TRACE=0`` keeps the stock Result bytes), the
launch observer at the model's launch sites, a traced request end to end
through the port's scheduler and its Perfetto export, the sanitizer, the
logging setup, the profiling hooks and the two tools.
"""

import asyncio
import json
import logging
import sys
import threading
import time
import types

import numpy as np
import pytest

from distributed_bitcoinminer_tpu.bitcoin import message as ref_message
from distributed_bitcoinminer_tpu.utils import trace as ref_trace
from distributed_bitcoinminer_tpu_torch.apps.miner import MinerWorker
from distributed_bitcoinminer_tpu_torch.bitcoin.hash import (scan_min,
                                                             scan_until)
from distributed_bitcoinminer_tpu_torch.bitcoin.message import (
    Message, new_request, new_result)
from distributed_bitcoinminer_tpu_torch.lsp.errors import LspError
from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
from distributed_bitcoinminer_tpu_torch.tools import dbmtrace, trace_census
from distributed_bitcoinminer_tpu_torch.utils import logging as port_logging
from distributed_bitcoinminer_tpu_torch.utils import profiling, sanitize
from distributed_bitcoinminer_tpu_torch.utils import trace
from distributed_bitcoinminer_tpu_torch.utils.metrics import registry

PHASES = trace.SPAN_PHASES
EVENTS = ("assign", "result", "merge", "lease_blown", "reissue", "park",
          "queue_alarm", "miner_drop", "stale_result", "cache_hit",
          "quarantine", "inflight_alarm", "miner_span")


def _span(rng):
    span = {k: round(float(rng.uniform(0, 2)), 6) for k in PHASES
            if rng.random() < 0.85}
    if rng.random() < 0.4:
        span.update(launch=int(rng.integers(1, 5)), lanes=3)
    if rng.random() < 0.3:
        span["subs"] = int(rng.integers(1, 14))
    return span


def _trace_dict(rng, key, tenants, miners):
    t, events = 0.0, []

    def ev(name, **kw):
        nonlocal t
        t += round(float(rng.uniform(0, 0.3)), 6)
        events.append({"t": round(t, 6), "event": name, **kw})
    ev("enqueue", queue_depth=int(rng.integers(0, 5)))
    if rng.random() < 0.9:
        ev("dispatch", job=key, miners=[int(m) for m in miners[:2]])
    for _ in range(int(rng.integers(0, 8))):
        name = str(rng.choice(EVENTS))
        if name == "miner_span":
            span = _span(rng)
            ev(name, miner=int(rng.choice(miners)), idx=int(
                rng.integers(0, 4)), **span,
               **({"slow": trace.slow_phase(span)}
                  if trace.slow_phase(span) else {}))
        else:
            ev(name, miner=int(rng.choice(miners)), idx=0)
    if rng.random() < 0.8:
        ev("reply", hash=int(rng.integers(0, 1 << 62)), nonce=7,
           elapsed_s=round(t, 6))
    elif rng.random() < 0.5:
        ev("cancel", reason="client_drop")
    d = {"key": key, "meta": {"data": "m", "lower": 0,
                              "upper": int(rng.integers(1, 10 ** 6)),
                              "target": int(rng.choice([0, 1 << 60])),
                              "client": int(rng.choice(tenants))},
         "events": events}
    if rng.random() < 0.8:
        d["t0"] = round(1000.0 + float(rng.uniform(0, 5)), 6)
    return d


@pytest.mark.parametrize("seed", range(5))
def test_chrome_export_equals_jax(seed):
    rng = np.random.default_rng(seed)
    tenants, miners = [1, 2, 3, 4], [101, 102, 103]
    dicts = [_trace_dict(rng, k, tenants, miners) for k in range(1, 12)]
    tt = {"1": 5, "3": 6} if seed % 2 else None
    mt = {"102": 9} if seed % 2 else None
    got = trace.to_chrome_trace(dicts, tenant_tracks=tt, miner_tracks=mt)
    want = ref_trace.to_chrome_trace(dicts, tenant_tracks=tt,
                                     miner_tracks=mt)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    ts = [(e["pid"], e["tid"], e["ts"]) for e in got["traceEvents"]
          if e["ph"] != "M"]
    assert ts == sorted(ts)


def test_slow_phase_and_sampling_equal_jax():
    rng = np.random.default_rng(11)
    spans = [_span(rng) for _ in range(200)] + [
        {}, {"force_s": "3"}, {"queue_s": -1.0}, {"wait_s": True},
        {"gap_s": 0.0, "force_s": 0.0}, {"dispatch_s": 2, "force_s": 2}]
    for span in spans:
        assert trace.slow_phase(span) == ref_trace.slow_phase(span)
    for rate in (0.0, 0.01, 0.25, 0.5, 0.999, 1.0, 1.5, -1.0):
        seqs = [int(x) for x in rng.integers(0, 1 << 40, 500)]
        assert [trace.sample_hit(s, rate) for s in seqs] == \
            [ref_trace.sample_hit(s, rate) for s in seqs]


@pytest.fixture
def fake_time(monkeypatch):
    """One stepped ``time.monotonic`` for both trace modules."""
    clock = types.SimpleNamespace(t=50.0)
    fake = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                    if not k.startswith("_")})
    fake.monotonic = lambda: clock.t
    for mod in (trace, ref_trace):
        monkeypatch.setattr(mod, "time", fake)
    return clock


def _dump_doc(caplog, name):
    rec = [r for r in caplog.records if r.name == name
           and "flight recorder dump" in r.getMessage()][-1]
    return json.loads(rec.getMessage().split("): ", 1)[1])


@pytest.mark.parametrize("cap", [0, 1, 7, 64])
def test_flight_recorder_equals_jax(fake_time, caplog, cap):
    rng = np.random.default_rng(cap)
    port, ref = trace.FlightRecorder(cap), ref_trace.FlightRecorder(cap)
    for i in range(40):
        fake_time.t += float(rng.uniform(0, 0.5))
        detail = {"job": int(rng.integers(0, 9)), "idx": i}
        if rng.random() < 0.3:
            detail["miner"] = int(rng.integers(100, 104))
        name = f"edge{int(rng.integers(0, 4))}"
        port.record(name, **detail)
        ref.record(name, **detail)
    assert port.events() == ref.events()
    assert len(port) == len(ref)
    with caplog.at_level(logging.WARNING):
        port.dump("why")
        ref.dump("why")
    if cap > 0:
        assert _dump_doc(caplog, "dbmt.trace") == _dump_doc(caplog,
                                                            "dbm.trace")
    else:
        assert not [r for r in caplog.records
                    if "flight recorder dump" in r.getMessage()]


def test_flight_helpers_follow_the_knob(monkeypatch, caplog):
    monkeypatch.setattr(trace, "_flight", trace.FlightRecorder(8))
    monkeypatch.setenv("DBMT_TRACE", "0")
    trace.flight("off")
    assert trace.flight_recorder().events() == []
    assert trace.ensure_tracer() is False
    monkeypatch.setenv("DBMT_TRACE", "1")
    trace.flight("on", job=1)
    assert [e["event"] for e in trace.flight_recorder().events()] == ["on"]
    with caplog.at_level(logging.WARNING):
        trace.flight_dump("test")
    doc = _dump_doc(caplog, "dbmt.trace")
    assert doc["why"] == "test" and doc["events"][0]["job"] == 1


def test_excepthook_dumps_then_chains(monkeypatch, caplog):
    seen = []
    monkeypatch.setattr(sys, "excepthook", lambda *a: seen.append(a))
    monkeypatch.setattr(trace, "_excepthook_installed", False)
    monkeypatch.setattr(trace, "_flight", trace.FlightRecorder(8))
    trace._install_excepthook()
    exc = ValueError("boom")
    with caplog.at_level(logging.WARNING):
        sys.excepthook(ValueError, exc, None)
    assert seen == [(ValueError, exc, None)]
    doc = _dump_doc(caplog, "dbmt.trace")
    assert doc["why"] == "unhandled-exception exit"
    assert doc["events"][-1]["event"] == "unhandled_exception"


@pytest.mark.parametrize("bound", [2, 5, 64])
def test_trackset_equals_jax(bound):
    rng = np.random.default_rng(bound)
    port, ref = trace.TrackSet(bound), ref_trace.TrackSet(bound)
    for _ in range(300):
        fam = str(rng.choice(["trace_track", "other"]))
        labels = ({"tenant": str(rng.integers(0, 12))} if rng.random() < 0.5
                  else {"miner": str(rng.integers(100, 110))})
        if rng.random() < 0.25:
            port.retire(fam, **labels)
            ref.retire(fam, **labels)
        else:
            assert port.track(fam, **labels) == ref.track(fam, **labels)
        assert port.items(fam) == ref.items(fam)
        assert len(port) == len(ref)
    assert port._overflows == ref._overflows


def test_launch_observer_equals_jax_compile_observer(fake_time, caplog):
    """The same bookkeeping as the JAX compile observer: a signature's
    first launch time, later launches counted, and one storm alarm per
    burst of fresh signatures inside the window."""
    rng = np.random.default_rng(5)
    port = trace.LaunchObserver(storm_n=3, storm_s=10.0)
    ref = ref_trace.CompileObserver(storm_n=3, storm_s=10.0)
    storms0 = registry().counter("trace.launch_storms").value
    for _ in range(200):
        fake_time.t += float(rng.choice([0.1, 1.0, 6.0]))
        sig = ("devloop_span", int(rng.integers(0, 8)), 9, None, "rolled")
        secs = float(rng.uniform(0, 0.5))
        assert port.launch(sig, secs) == ref.launch(sig, secs)
        assert port._storming == ref._storming
        assert list(port._fresh) == list(ref._fresh)
    assert {s: (r["n"], r["first_s"]) for s, r in port.sigs.items()} == \
        {s: (r["n"], r["compile_s"]) for s, r in ref.sigs.items()}
    assert [(k, v["n"]) for k, v in port.snapshot().items()] == \
        [(k, v["n"]) for k, v in ref.snapshot().items()]
    assert registry().counter("trace.launch_storms").value > storms0


def test_model_launch_sites_are_observed(monkeypatch):
    monkeypatch.setattr(trace, "_observer", trace.LaunchObserver())
    s = NonceSearcher("observed", device="cpu")
    assert s.search(0, 1_200) == scan_min("observed", 0, 1_200)
    assert s.last_dispatch_subs == 4       # 10^0, 10^1, 10^2, 10^3 blocks
    s.search_until(0, 99, 1)
    s.finalize_batch(s.dispatch_batch([(s, 0, 50), (s, 7, 30)]))
    sigs = trace.launch_observer().sigs
    assert ("devloop_span", 0, None, "rolled") in sigs
    assert any(sig[0] == "devloop_span_until" for sig in sigs)
    assert any(sig[0] == "span_segmin" for sig in sigs)
    assert all(rec["n"] >= 1 and rec["first_s"] >= 0
               for rec in sigs.values())
    monkeypatch.setenv("DBMT_TRACE", "0")
    before = {k: dict(v) for k, v in sigs.items()}
    s.search(0, 1_200)
    assert trace.launch_observer().sigs == before


# ------------------------------------------------------------------ wire

@pytest.mark.parametrize("seed", range(3))
def test_result_bytes_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        h = int(rng.integers(0, 1 << 63)) * 2 + 1
        nonce = int(rng.integers(0, 1 << 62))
        target = int(rng.choice([0, 1 << 60]))
        span = _span(rng) if rng.random() < 0.7 else None
        got = new_result(h, nonce, target, span=span).to_json()
        assert got == ref_message.new_result(h, nonce, target,
                                             span=span).to_json()
        assert Message.from_json(got).span == (span or None)
        assert (b'"Span"' in got) == bool(span)
    assert new_result(5, 6).to_json() == \
        b'{"Type":2,"Data":"","Lower":0,"Upper":0,"Hash":5,"Nonce":6}'


# ----------------------------------------------------------- miner spans

class ScriptedClient:
    """An LSP client that hands the worker a fixed list of Requests, all
    queued at once, then dies; it records what the worker writes."""

    def __init__(self, msgs):
        self.inbox = [m.to_json() for m in msgs]
        self.sent = []
        self.expect = len(msgs)

    async def read(self):
        if self.inbox:
            return self.inbox.pop(0)
        while len(self.sent) < self.expect:
            await asyncio.sleep(0.01)
        raise LspError("closed")

    def write(self, payload):
        self.sent.append(payload)

    async def close(self):
        pass


def _serve(msgs, **kw):
    from tests.test_torch_apps import cpu_factory
    w = MinerWorker("127.0.0.1:1", searcher_factory=cpu_factory(), **kw)
    w.client = ScriptedClient(msgs)
    asyncio.run(asyncio.wait_for(w.run(), 60))
    return [Message.from_json(p) for p in w.client.sent], w.client.sent


MICE = [new_request("mouse a", 0, 300), new_request("mouse b", 50, 900),
        new_request("mouse c", 7, 70)]
ALONE = new_request("elephant", 0, 30_000)
TARGETED = new_request("until", 0, 5_000, 1 << 60)


def test_miner_spans_on_results():
    """A coalesced window's spans share one launch id with ``lanes`` its
    size; a lone two-phase chunk carries ``subs`` (its chain's blocks);
    a difficulty chunk is one serial force; every phase is >= 0; answers
    and their order are the stock ones."""
    out, _raw = _serve(MICE + [ALONE, TARGETED], coalesce_max=1_000)
    want = [scan_min(m.data, m.lower, m.upper + 1) for m in MICE] + [
        scan_min(ALONE.data, 0, ALONE.upper + 1),
        scan_until(TARGETED.data, 0, TARGETED.upper + 1,
                   TARGETED.target)[:2]]
    assert [(m.hash, m.nonce) for m in out] == want
    vocab = set(trace.SPAN_PHASES + trace.SPAN_EXTRAS)
    for m in out:
        assert m.span and set(m.span) <= vocab
        assert all(m.span[k] >= 0 for k in trace.SPAN_PHASES
                   if k in m.span)
        assert {"queue_s", "wait_s", "force_s"} <= set(m.span)
    window = [m.span for m in out[:3]]
    assert {s["launch"] for s in window} == {1}
    assert all(s["lanes"] == 3 and "dispatch_s" in s for s in window)
    alone = out[3].span
    assert "launch" not in alone and alone["subs"] == 5
    assert "dispatch_s" in alone and "gap_s" in alone
    assert out[4].span["serial"] == 1 and "dispatch_s" not in out[4].span
    assert out[4].target == TARGETED.target


def test_untraced_results_are_stock_bytes(monkeypatch):
    monkeypatch.setenv("DBMT_TRACE", "0")
    out, raw = _serve(MICE + [ALONE, TARGETED], coalesce_max=1_000)
    assert all(b'"Span"' not in p for p in raw)
    assert raw == [new_result(m.hash, m.nonce, m.target).to_json()
                   for m in out]
    assert all(m.span is None for m in out)


# -------------------------------------------------------- end to end

def test_traced_requests_end_to_end_and_export(tmp_path):
    """Requests through the port's scheduler and a CPU miner over
    localhost LSP: each request's trace holds a ``miner_span`` per
    answered chunk, and the Perfetto export one ``request`` slice a
    request, ``dbmtrace convert`` writing the same document."""
    from tests.test_torch_apps import Cluster, fast_params
    from distributed_bitcoinminer_tpu_torch.apps.client import submit

    async def scenario():
        async with Cluster(fast_params()) as c:
            await c.start_miner()
            await c.start_miner()
            got = [await asyncio.wait_for(submit(c.hostport, d, n,
                                                 c.params), 30)
                   for d, n in (("traced", 4_000), ("again", 900))]
            return got, c.scheduler
    got, sched = asyncio.run(scenario())
    assert got == [scan_min("traced", 0, 4_001), scan_min("again", 0, 901)]
    traces = dict(sched.tenant_plane.traces.items())
    assert sorted(traces) == [1, 2]
    for t in traces.values():
        names = [e["event"] for e in t.events]
        assert names.count("miner_span") == names.count("result") >= 1
        assert names[-1] == "reply"
    path = tmp_path / "trace.json"
    doc = sched.export_trace(str(path))
    slices = [e for e in doc["traceEvents"] if e["ph"] == "X"
              and e["name"].startswith("request ")]
    assert sorted(e["name"] for e in slices) == ["request 1", "request 2"]
    assert json.loads(path.read_text()) == json.loads(json.dumps(doc))
    dump = tmp_path / "dump.jsonl"
    dump.write_text("".join(json.dumps(t.to_dict()) + "\n"
                            for t in traces.values()))
    out = tmp_path / "converted.json"
    assert dbmtrace.main(["convert", str(dump), "-o", str(out)]) == 0
    assert json.loads(out.read_text()) == trace.to_chrome_trace(
        [t.to_dict() for t in traces.values()])


def test_dbmtrace_summarize_reads_log_dumps(tmp_path, capsys):
    rng = np.random.default_rng(3)
    dicts = [_trace_dict(rng, k, [1, 2], [101, 102]) for k in range(8)]
    log = tmp_path / "log.txt"
    log.write_text("".join(
        f"12:00:00.000 dbmt.scheduler W trace dump (in-flight age alarm): "
        f"{json.dumps(d)}\nnoise line\n" for d in dicts))
    assert dbmtrace.main(["summarize", str(log), "--top", "3"]) == 0
    text = capsys.readouterr().out
    assert text.startswith("8 trace(s)")
    assert "slowest" in text or "phase" in text
    empty = tmp_path / "empty.txt"
    empty.write_text("nothing\n")
    assert dbmtrace.main(["summarize", str(empty)]) == 1


# ------------------------------------------------ sanitizer, logs, tools

def test_sanitizer_ownership_and_off_loop(monkeypatch, caplog):
    monkeypatch.setenv("DBMT_SANITIZE", "0")
    assert sanitize.ensure_sanitizer() is False
    owner = sanitize.ThreadOwner("tables")
    before = registry().counter("sanitize.ownership_violations").value
    assert owner.assert_here()
    box = []
    t = threading.Thread(target=lambda: box.append(owner.assert_here()))
    with caplog.at_level(logging.WARNING):
        t.start()
        t.join()
    assert box == [False]
    assert registry().counter("sanitize.ownership_violations").value \
        == before + 1
    assert sanitize.assert_off_loop("compute") is True

    async def on_loop():
        return sanitize.assert_off_loop("compute")
    assert asyncio.run(on_loop()) is False


def test_sanitizer_watchdog_names_a_stall(caplog):
    slow = registry().counter("sanitize.slow_callbacks")
    before = slow.value

    async def stall():
        time.sleep(0.03)
    try:
        sanitize.install_watchdog(0.01)
        with caplog.at_level(logging.WARNING):
            asyncio.run(stall())
    finally:
        sanitize.uninstall_watchdog()
    assert slow.value > before
    assert any("event-loop stall" in r.getMessage()
               and "stall" in r.getMessage() for r in caplog.records)


def test_configure_logging_is_idempotent(tmp_path):
    log = tmp_path / "log.txt"
    root = port_logging.configure_logging(logging.INFO, logfile=str(log))
    try:
        port_logging.configure_logging(logging.INFO, logfile=str(log))
        assert sum(isinstance(h, logging.FileHandler)
                   for h in root.handlers) == 1
        logging.getLogger("dbmt.scheduler").info("hello log")
        assert "hello log" in log.read_text()
    finally:
        port_logging.configure_logging(logging.INFO)
        for h in list(root.handlers):
            root.removeHandler(h)
        port_logging._installed.update(handler=None, sink=None)


def test_profiling_device_trace_writes_chrome_trace(tmp_path):
    path = tmp_path / "sub" / "p.json"
    with profiling.device_trace(str(path)) as prof:
        NonceSearcher("profiled", device="cpu").search(0, 999)
    assert prof is not None
    doc = json.loads(path.read_text())
    assert doc["traceEvents"]


def test_census_reads_device_intervals(monkeypatch):
    doc = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 5, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 30,
         "dur": 2},
        {"ph": "X", "cat": "cpu_op", "name": "host", "ts": 0, "dur": 99},
        {"ph": "i", "cat": "kernel", "name": "mark", "ts": 1}]}
    iv = trace_census.device_intervals(doc)
    assert [e[1] for e in iv] == ["k1", "k2", "copy"]
    assert trace_census.union_us([(a, b) for _c, _n, a, b in iv]) == 17.0
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert trace_census.main([]) == 1
