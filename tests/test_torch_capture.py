"""The capture plane (the port's ``apps/capture.py``) against the JAX
package's.

Both packages' schedulers are driven through the seeded storms of
``tests/test_torch_sched.py`` (every feature on, the two schedulers held
to each other after every event) with a capture each, under the shared
fake clock (also patched into both capture modules, with one wall time
and one tenant salt): the two capture files must be equal line for line,
hashed tenant keys included. Then rotation past ``DBMT_CAPTURE_LINES``
(each window loading alone), the refusal of an unknown version,
``capture_baseline``, ``replay_plan`` and ``fidelity`` against the JAX
functions on a file written by each package (each package's loader on
each file), the ``DBMT_CAPTURE*`` readers against their twins, and with
capture off: no capture object anywhere and the wire bytes the stock
ones.
"""

import json
import types

import pytest

from distributed_bitcoinminer_tpu.apps import capture as ref_capmod
from distributed_bitcoinminer_tpu_torch.apps import capture as capmod
from distributed_bitcoinminer_tpu_torch.apps.scheduler import Scheduler
from distributed_bitcoinminer_tpu_torch.bitcoin.message import (new_join,
                                                                new_request)
from distributed_bitcoinminer_tpu_torch.utils import config
from tests.test_torch_sched import (MINER_A, TEN_X, TEN_Y,  # noqa: F401
                                    FakeServer, _storm, clock)

SALT = "5eed" * 4
WALL = 1_792_000_000.0
KINDS = ("hdr", "cfg", "req", "rep", "shed", "cancel", "span", "pool")


@pytest.fixture
def cap_clock(clock, monkeypatch):
    """The storms' fake clock in both capture modules too, and one wall
    time."""
    import time
    fake = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                    if not k.startswith("_")})
    fake.monotonic = clock.monotonic
    fake.time = lambda: WALL
    for mod in (capmod, ref_capmod):
        monkeypatch.setattr(mod, "time", fake)
    return clock


def _twins(tmp_path, tag="", **kw):
    """A capture of each package with the same salt."""
    port = capmod.WorkloadCapture(path=str(tmp_path / f"port{tag}.jsonl"),
                                  **kw)
    ref = ref_capmod.WorkloadCapture(path=str(tmp_path / f"jax{tag}.jsonl"),
                                     **kw)
    port._salt = ref._salt = SALT
    return port, ref


def _lines(path) -> list:
    with open(path, encoding="utf-8") as fh:
        return fh.read().splitlines()


def _captured_storm(tmp_path, monkeypatch, clock, seed):
    port, ref = _twins(tmp_path, tag=str(seed), snap_s=0.0)
    monkeypatch.setattr(capmod, "ensure_from_env", lambda: port)
    monkeypatch.setattr(ref_capmod, "ensure_from_env", lambda: ref)
    p, _ = _storm(clock, seed)
    assert p.port.capture is port and p.ref.capture is ref
    port.close()
    ref.close()
    return p, port.path, ref.path


@pytest.mark.parametrize("seed", [0, 3])
def test_storm_captures_equal_jax_line_for_line(tmp_path, monkeypatch,
                                                cap_clock, seed):
    p, port_path, ref_path = _captured_storm(tmp_path, monkeypatch,
                                             cap_clock, seed)
    got, want = _lines(port_path), _lines(ref_path)
    assert got == want
    kinds = [json.loads(line)["k"] for line in got]
    for kind in KINDS[:4] + ("span", "pool"):
        assert kind in kinds, kind
    stats = p.port.stats
    # Every answer is a reply record; every shed victim a shed record.
    assert kinds.count("rep") == stats["results_sent"]
    assert kinds.count("shed") == stats["qos_shed"]
    assert kinds.count("req") >= stats["results_sent"]


def test_storms_capture_every_record_kind(tmp_path, monkeypatch, cap_clock):
    """Between them the storms shed, cancel, replay from the cache and
    fold spans into the capture."""
    seen = set()
    for seed in (0, 3, 5):
        _, port_path, _ = _captured_storm(tmp_path, monkeypatch, cap_clock,
                                          seed)
        for line in _lines(port_path):
            rec = json.loads(line)
            seen.add(rec["k"])
            if rec.get("cached"):
                seen.add("cached")
    assert set(KINDS) | {"cached"} <= seen


def test_rotation_past_capture_lines(tmp_path, monkeypatch, cap_clock):
    """Past DBMT_CAPTURE_LINES (at least 1024) the file becomes ``.1`` and
    a new one starts with its header and the attach config; both windows
    load alone, and both packages rotate alike."""
    monkeypatch.setenv("DBMT_CAPTURE_LINES", "10")       # clamped to 1024
    monkeypatch.setenv("DBM_CAPTURE_LINES", "10")
    port, ref = _twins(tmp_path, snap_s=0.0)
    assert port.max_lines == ref.max_lines == 1024
    for cap in (port, ref):
        cap.config(max_queued=8, qos=True)
    for i in range(1500):
        for cap in (port, ref):
            cap.request(i % 7, 6, 100 + i, i % 3 == 0)
        cap_clock.step(0.001)
    port.close()
    ref.close()
    for suffix in ("", ".1"):
        assert _lines(port.path + suffix) == _lines(ref.path + suffix)
        loaded = capmod.load_capture(port.path + suffix)
        assert loaded.header["v"] == capmod.CAPTURE_VERSION
        assert loaded.cfg == {"max_queued": 8, "qos": True}
    assert port.info()["rotations"] == 1
    first = _lines(port.path)[:2]
    assert [json.loads(x)["k"] for x in first] == ["hdr", "cfg"]


def test_unknown_versions_and_foreign_files_are_refused(tmp_path):
    path = tmp_path / "cap.jsonl"
    for loader in (capmod.load_capture, ref_capmod.load_capture):
        path.write_text(json.dumps({"k": "hdr", "v": 2}) + "\n")
        with pytest.raises(ValueError, match="unsupported capture version"):
            loader(str(path))
        path.write_text(json.dumps({"k": "req", "t": 0}) + "\n")
        with pytest.raises(ValueError, match="not a workload capture"):
            loader(str(path))
        path.write_text("")
        with pytest.raises(ValueError, match="empty capture"):
            loader(str(path))
        path.write_text(json.dumps({"k": "hdr", "v": 1}) + "\n"
                        + json.dumps({"k": "hdr", "v": 3}) + "\n")
        with pytest.raises(ValueError, match="mixed capture versions"):
            loader(str(path))
    # A torn tail line is skipped.
    path.write_text(json.dumps({"k": "hdr", "v": 1}) + "\n"
                    + json.dumps({"k": "req", "t": 0.5, "ten": "a", "n": 9})
                    + "\n" + '{"k": "rep", "t"')
    assert len(capmod.load_capture(str(path)).reqs) == 1


def _as_dict(cap) -> dict:
    return {k: getattr(cap, k) for k in ("header", "cfg", "reqs", "reps",
                                         "sheds", "cancels", "reissues",
                                         "spans", "pools")}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_replay_plan_baseline_fidelity_equal_jax(tmp_path, monkeypatch,
                                                 cap_clock, writer):
    _, port_path, ref_path = _captured_storm(tmp_path, monkeypatch,
                                             cap_clock, 3)
    path = port_path if writer == "port" else ref_path
    cap, ref = capmod.load_capture(path), ref_capmod.load_capture(path)
    assert _as_dict(cap) == _as_dict(ref)
    assert cap.pool_rates() == ref.pool_rates()
    base = capmod.capture_baseline(cap)
    assert base == ref_capmod.capture_baseline(ref)
    assert base["requests"] == len(cap.reqs) > 0
    tenants = {r["ten"] for r in cap.reqs[:5]}
    assert capmod.capture_baseline(cap, tenants) == \
        ref_capmod.capture_baseline(ref, tenants)
    for max_tenants in (None, 2):
        plan = capmod.replay_plan(cap, max_tenants)
        assert plan == ref_capmod.replay_plan(ref, max_tenants)
    plan = capmod.replay_plan(cap)
    assert sum(len(t["reqs"]) for t in plan) == len(cap.reqs)
    assert [t["name"] for t in plan] == [f"r{i}" for i in range(len(plan))]
    variants = [dict(base), dict(base, admitted_per_s=0.0),
                dict(base, p99_s=(base["p99_s"] or 1.0) * 9,
                     shed_rate=0.9, requests=base["requests"] + 1),
                dict(base, admitted_per_s=None, p99_s=None)]
    for rep in variants:
        for speed, bounds in ((1.0, None), (4.0, None),
                              (1.0, {"admitted_ratio": None})):
            got = capmod.fidelity(base, rep, speed, bounds)
            assert got == ref_capmod.fidelity(base, rep, speed, bounds)
    assert capmod.fidelity(base, base)["within"]
    assert not capmod.fidelity(base, variants[2])["within"]
    assert capmod.FIDELITY_BOUNDS == ref_capmod.FIDELITY_BOUNDS


@pytest.mark.parametrize("env", [
    {}, {"CAPTURE": "1", "CAPTURE_PATH": "x.jsonl", "CAPTURE_LINES": "5000",
         "CAPTURE_SNAP_S": "0.5"},
    {"CAPTURE": "junk", "CAPTURE_LINES": "junk"}])
def test_capture_readers_equal_jax(monkeypatch, tmp_path, env):
    monkeypatch.chdir(tmp_path)
    for k, v in env.items():
        monkeypatch.setenv(f"DBMT_{k}", v)
        monkeypatch.setenv(f"DBM_{k}", v)
    assert capmod.enabled() == ref_capmod.enabled()
    port, ref = capmod.WorkloadCapture(), ref_capmod.WorkloadCapture()
    try:
        assert (port.max_lines, port.snap_s) == (ref.max_lines, ref.snap_s)
        want = env.get("CAPTURE_PATH", "dbmt_capture.jsonl")
        assert port.path == want
    finally:
        port.close()
        ref.close()


def _drive(sched):
    sched._on_join(MINER_A, new_join())
    sched._on_request(TEN_X, new_request("capture off", 0, 999))
    sched._on_request(TEN_Y, new_request("capture off", 0, 999))
    sched.sweep()


def test_capture_off_no_object_and_stock_wire_bytes(tmp_path, monkeypatch):
    monkeypatch.delenv("DBMT_CAPTURE", raising=False)
    monkeypatch.chdir(tmp_path)
    off_server = FakeServer()
    off = Scheduler(off_server)
    assert off.capture is None and off.tenant_plane._capture is None
    assert capmod._active is None
    _drive(off)
    on_server = FakeServer()
    cap = capmod.WorkloadCapture(path=str(tmp_path / "on.jsonl"), snap_s=0)
    on = Scheduler(on_server, capture=cap)
    _drive(on)
    cap.close()
    assert on_server.writes == off_server.writes
    assert [json.loads(x)["k"] for x in _lines(cap.path)] == \
        ["hdr", "cfg", "req", "req", "pool"]
    assert not list(tmp_path.glob("dbmt_capture*"))


def test_env_armed_capture_is_shared_and_refusable(tmp_path, monkeypatch):
    monkeypatch.setenv("DBMT_CAPTURE", "1")
    monkeypatch.setenv("DBMT_CAPTURE_PATH", str(tmp_path / "env.jsonl"))
    try:
        a, b = Scheduler(FakeServer()), Scheduler(FakeServer())
        assert a.capture is b.capture is capmod._active
        # An instance given refuses the environment's.
        own = capmod.WorkloadCapture(path=str(tmp_path / "own.jsonl"))
        assert Scheduler(FakeServer(), capture=own).capture is own
        own.close()
    finally:
        capmod.close_active()
    assert capmod._active is None
    assert [json.loads(x)["k"] for x in _lines(tmp_path / "env.jsonl")] == \
        ["hdr", "cfg", "cfg"]
    assert config.capture_from_env().enabled
