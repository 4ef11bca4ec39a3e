"""The port's adapt plane against the JAX package's ``apps/adapt.py``.

Each controller of ``distributed_bitcoinminer_tpu_torch.apps.adapt`` and
its JAX twin are fed the same seeded observation sequences (numpy), each
side with its own fake clock stepped alike, and after every step their
returned values, current values, histories and internal sample state are
equal; so are :func:`oscillation_ratios` on seeded histories, the
plane's gauges, and the new ``DBMT_*`` readers (adapt, the LSP params,
the coalescing sizes, the pipeline depth) against their ``DBM_*`` twins.
"""

import numpy as np
import pytest

from distributed_bitcoinminer_tpu.apps import adapt as ref_adapt
from distributed_bitcoinminer_tpu.utils import config as ref_config
from distributed_bitcoinminer_tpu.utils.metrics import Registry as RefRegistry
from distributed_bitcoinminer_tpu_torch.apps import adapt
from distributed_bitcoinminer_tpu_torch.lsp.params import Params
from distributed_bitcoinminer_tpu_torch.utils import config
from distributed_bitcoinminer_tpu_torch.utils.metrics import Registry


class FakeClock:
    def __init__(self, t=500.0):
        self.t = t

    def __call__(self):
        return self.t


def _hist(rng, n):
    t, v, out = 0.0, float(rng.uniform(0.1, 5.0)), []
    for _ in range(n):
        t += float(rng.uniform(0.0, 2.0))
        step = rng.choice([0.5, 0.7, 1.0, 1.3, 2.0])
        v = max(0.05, v * float(step))
        out.append((t, v))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_oscillation_ratios_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 2, 3, 5, 17, 60):
        h = _hist(rng, n)
        assert adapt.oscillation_ratios(h) == ref_adapt.oscillation_ratios(h)
        assert adapt.oscillation_ratio(h) == ref_adapt.oscillation_ratio(h)


def _pair(make):
    """One object of each package from ``make(module, clock)``, with its
    own clock; ``step(dt)`` moves both clocks."""
    cp, cr = FakeClock(), FakeClock()

    def step(dt):
        cp.t += dt
        cr.t += dt
    return make(adapt, cp), make(ref_adapt, cr), step


def _aimd_state(a):
    return (a.value, a.floor, a.ceil, a.adjustments, list(a.history))


@pytest.mark.parametrize("seed", range(4))
def test_aimd_value_equal_jax(seed):
    rng = np.random.default_rng(seed)
    kw = dict(value=float(rng.uniform(0.01, 20)), floor=0.05, ceil=10.0,
              add=float(rng.choice([0.05, 0.25, 8.0])),
              mul=float(rng.choice([0.5, 0.7])),
              add_frac=float(rng.choice([0.0, 0.1])))
    port, ref, step = _pair(lambda m, c: m.AimdValue(clock=c, **kw))
    for _ in range(200):
        op = int(rng.integers(0, 3))
        step(float(rng.uniform(0, 1)))
        if op == 0:
            got = (port.increase(), ref.increase())
        elif op == 1:
            got = (port.decrease(), ref.decrease())
        else:
            floor = None if rng.random() < 0.3 \
                else float(rng.uniform(0.01, 5))
            got = (port.decrease_floored(floor), ref.decrease_floored(floor))
        assert got[0] == got[1]
        assert _aimd_state(port) == _aimd_state(ref)


def _chunk_state(c):
    miners = {m: (st["lat"].value, st["n"], st["margin"], st["settle"],
                  None if st["aimd"] is None else _aimd_state(st["aimd"]))
              for m, st in c._miners.items()}
    return (_aimd_state(c.aimd), c._latency.value, c._min_margin,
            c._samples, c._settle, c._diverged, c._unfork_pending, miners)


@pytest.mark.parametrize("per_miner", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_chunk_size_controller_equal_jax(seed, per_miner):
    """Service times, margins, force spans by miner, rate ratios, ticks,
    per-miner ticks, forgets and un-forks."""
    rng = np.random.default_rng(seed)
    port, ref, step = _pair(lambda m, c: m.ChunkSizeController(
        1.0, 1.0, 0.35, clock=c, per_miner=per_miner))
    miners = [101, 102, 103]
    for i in range(300):
        # Latencies in regimes below, around and above the setpoint, so
        # the value climbs from its floor as well as falls.
        scale = (0.5, 1.6, 3.0)[(i // 40) % 3]
        r = rng.random()
        if r < 0.6:
            args = (None if rng.random() < 0.1
                    else float(rng.uniform(0.0, scale)),
                    None if rng.random() < 0.3
                    else float(rng.uniform(0.2, 1.0)),
                    None if rng.random() < 0.4
                    else float(rng.uniform(0.0, scale)),
                    int(rng.choice(miners)))
            port.observe(*args[:3], miner=args[3])
            ref.observe(*args[:3], miner=args[3])
        elif r < 0.7:
            ratio = None if rng.random() < 0.3 \
                else float(rng.uniform(1.0, 10.0))
            port.note_rate_ratio(ratio)
            ref.note_rate_ratio(ratio)
        elif r < 0.8:
            step(1.0)
            assert port.tick() == ref.tick()
        elif r < 0.9:
            step(0.5)
            assert port.tick_miners() == ref.tick_miners()
            assert port.unfork_pending() == ref.unfork_pending()
        else:
            m = int(rng.choice(miners))
            port.forget_miner(m)
            ref.forget_miner(m)
        assert _chunk_state(port) == _chunk_state(ref)


def _window_state(w):
    return (_aimd_state(w.aimd), w._small_arrivals, w._last_tick,
            w._wait.value, w._gap.value, w._gap_samples)


@pytest.mark.parametrize("seed", range(3))
def test_coalesce_window_controller_equal_jax(seed):
    rng = np.random.default_rng(seed)
    port, ref, step = _pair(lambda m, c: m.CoalesceWindowController(
        0.25, 0.35, clock=c))
    for _ in range(300):
        r = rng.random()
        if r < 0.4:
            small = bool(rng.random() < 0.8)
            port.observe_arrival(small)
            ref.observe_arrival(small)
        elif r < 0.6:
            w = float(rng.uniform(-0.1, 0.5))
            port.observe_wait(w)
            ref.observe_wait(w)
        elif r < 0.8:
            g = float(rng.choice([rng.uniform(0, 0.5), rng.uniform(0, 5)]))
            port.observe_gap(g)
            ref.observe_gap(g)
        else:
            step(float(rng.uniform(0.1, 2.0)))
            assert port.tick() == ref.tick()
        assert _window_state(port) == _window_state(ref)


def _admission_state(a):
    b = a.bucket
    return (_aimd_state(a.aimd), b.rate, b.burst, b._tokens, b._t,
            a._prev_age, a._srv.value, a._settle, a.shed, a.queue_bound())


@pytest.mark.parametrize("rate0", [0.0, 40.0])
@pytest.mark.parametrize("seed", range(3))
def test_admission_controller_equal_jax(seed, rate0):
    rng = np.random.default_rng(seed)
    port, ref, step = _pair(lambda m, c: m.AdmissionController(rate0,
                                                               clock=c))
    age = 0.0
    for _ in range(300):
        r = rng.random()
        if r < 0.5:
            step(float(rng.uniform(0.0, 0.05)))
            assert port.admit() == ref.admit()
        elif r < 0.65:
            srv = float(rng.uniform(0, 200))
            port.observe_service_rate(srv)
            ref.observe_service_rate(srv)
        else:
            step(float(rng.uniform(0.1, 1.5)))
            age = max(0.0, age + float(rng.uniform(-0.5, 0.6)))
            assert port.tick(age) == ref.tick(age)
        assert _admission_state(port) == _admission_state(ref)


PLANE_PARAMS = [{}, {"rate0": 25.0, "band": 0.2},
                {"per_miner": True, "tick_s": 0.5},
                {"chunk": False}, {"coalesce": False, "admit": False}]


def _gauges(snapshot):
    return {k: v for k, v in snapshot.get("gauges", {}).items()
            if k.startswith("adapt")}


@pytest.mark.parametrize("case", range(len(PLANE_PARAMS)))
def test_adapt_plane_equal_jax(case):
    """The plane over seeded chunk pops (with and without spans, sized or
    not), arrivals, waits, admissions, forgets and sweep ticks with
    queue ages, served totals and rate ratios: every tick's changes, the
    histories, the state, the congestion bound and the gauges agree."""
    rng = np.random.default_rng(case)
    fields = PLANE_PARAMS[case]
    cp, cr = FakeClock(), FakeClock()
    pm, rm = Registry(), RefRegistry()
    # The JAX defaults, admission included (the port's is off).
    port = adapt.AdaptPlane(config.AdaptParams(**{"admit": True, **fields}),
                            pm, cp, chunk_s=1.0, small_s=0.25)
    ref = ref_adapt.AdaptPlane(ref_config.AdaptParams(**fields), rm, cr,
                               chunk_s=1.0, small_s=0.25)
    served = 0
    for _ in range(400):
        r = rng.random()
        if r < 0.45:
            span = None
            if rng.random() < 0.6:
                span = {"force_s": float(rng.uniform(0, 3)),
                        "gap_s": float(rng.uniform(0, 1)),
                        "lanes": 2, "bogus": "x"}
            args = dict(service_s=None if rng.random() < 0.2
                        else float(rng.uniform(0, 3)),
                        margin_frac=None if rng.random() < 0.3
                        else float(rng.uniform(0, 1)),
                        span=span, sized=bool(rng.random() < 0.7),
                        miner=int(rng.choice([101, 102])))
            port.observe_chunk(**args)
            ref.observe_chunk(**args)
        elif r < 0.6:
            small = bool(rng.random() < 0.7)
            port.observe_arrival(small)
            ref.observe_arrival(small)
            assert port.admit() == ref.admit()
        elif r < 0.7:
            w = float(rng.uniform(0, 1))
            port.observe_wait(w)
            ref.observe_wait(w)
        elif r < 0.73:
            port.forget_miner(101)
            ref.forget_miner(101)
        else:
            dt = float(rng.uniform(0.05, 1.5))
            cp.t += dt
            cr.t += dt
            served += int(rng.integers(0, 40))
            args = (float(rng.uniform(0, 2)), served,
                    None if rng.random() < 0.4
                    else float(rng.uniform(1, 12)))
            assert port.tick(*args) == ref.tick(*args)
        for bound in (0, 5, 1024):
            assert port.effective_max_queued(bound) == \
                ref.effective_max_queued(bound)
        assert port.histories() == ref.histories()
        assert port.state() == ref.state()
    assert _gauges(pm.snapshot()) == _gauges(rm.snapshot())


def test_plane_mounts_only_live_controllers():
    """chunk_s / small_s <= 0 leave those controllers off, as in the JAX
    package, and no gauge is made for a missing one."""
    for kw in ({"chunk_s": 0.0}, {"small_s": 0.0}, {}):
        reg = Registry()
        p = adapt.AdaptPlane(config.AdaptParams(admit=True), reg,
                             FakeClock(), **kw)
        r = ref_adapt.AdaptPlane(ref_config.AdaptParams(), RefRegistry(),
                                 FakeClock(), **kw)
        assert (p.chunk is None, p.window is None, p.admission is None) \
            == (r.chunk is None, r.window is None, r.admission is None)
        assert set(_gauges(reg.snapshot())) == \
            {"adapt_chunk_s", "adapt_small_s", "adapt_admit_rate"} \
            - ({"adapt_chunk_s"} if p.chunk is None else set()) \
            - ({"adapt_small_s"} if p.window is None else set())


# ------------------------------------------------------------ the readers

ADAPT_ENV = [
    {},
    {"ADAPT": "0"},
    {"ADAPT_TICK_S": "0.001", "ADAPT_BAND": "2", "ADAPT_FORCE_S": "0",
     "ADAPT_RATE0": "-3", "ADAPT_CHUNK": "0", "ADAPT_COALESCE": "0",
     "ADAPT_ADMIT": "0", "ADAPT_PER_MINER": "1"},
    {"ADAPT_TICK_S": "0.5", "ADAPT_BAND": "0.2", "ADAPT_FORCE_S": "2.5",
     "ADAPT_RATE0": "40", "ADAPT": "x", "ADAPT_PER_MINER": "yes"},
]


@pytest.mark.parametrize("case", range(len(ADAPT_ENV)))
def test_adapt_reader_equals_jax(monkeypatch, case):
    for key, value in ADAPT_ENV[case].items():
        monkeypatch.setenv(f"DBMT_{key}", value)
        monkeypatch.setenv(f"DBM_{key}", value)
    port, ref = config.adapt_from_env(), ref_config.adapt_from_env()
    assert port.__dataclass_fields__.keys() == ref.__dataclass_fields__.keys()
    for field in set(port.__dataclass_fields__) - {"admit"}:
        assert getattr(port, field) == getattr(ref, field), field
        assert getattr(config.AdaptParams(), field) == \
            getattr(ref_config.AdaptParams(), field), field
    # The admission controller's default is the port's one departure.
    assert port.admit is (ADAPT_ENV[case].get("ADAPT_ADMIT", "0") != "0")
    assert (config.AdaptParams().admit, ref_config.AdaptParams().admit) \
        == (False, True)
    monkeypatch.setenv("DBMT_ADAPT_ADMIT", "1")
    monkeypatch.setenv("DBM_ADAPT_ADMIT", "1")
    assert config.adapt_from_env().admit == ref_config.adapt_from_env().admit


LSP_ENV = [{}, {"EPOCH_LIMIT": "3", "EPOCH_MILLIS": "150", "WINDOW": "7",
                "MAX_BACKOFF": "2"},
           {"EPOCH_LIMIT": "x", "WINDOW": "", "MAX_BACKOFF": "1.5"}]
COALESCE_ENV = [{}, {"COALESCE": "0"},
                {"COALESCE_LANES": "1", "COALESCE_MAX": "0",
                 "COALESCE_SMALL_S": "0.5"},
                {"COALESCE_LANES": "16", "COALESCE_MAX": "4096",
                 "COALESCE_SMALL_S": "bad"}]


@pytest.mark.parametrize("case", range(len(LSP_ENV)))
def test_lsp_params_reader_equals_jax(monkeypatch, case):
    for key, value in LSP_ENV[case].items():
        monkeypatch.setenv(f"DBMT_{key}", value)
        monkeypatch.setenv(f"DBM_{key}", value)
    port = config.lsp_params_from_env()
    ref = ref_config.from_env().params
    assert isinstance(port, Params)
    assert (port.epoch_limit, port.epoch_millis, port.window_size,
            port.max_backoff_interval) == \
        (ref.epoch_limit, ref.epoch_millis, ref.window_size,
         ref.max_backoff_interval)


@pytest.mark.parametrize("case", range(len(COALESCE_ENV)))
def test_coalesce_reader_equals_jax(monkeypatch, case):
    for key, value in COALESCE_ENV[case].items():
        monkeypatch.setenv(f"DBMT_{key}", value)
        monkeypatch.setenv(f"DBM_{key}", value)
    port, ref = config.coalesce_from_env(), ref_config.coalesce_from_env()
    for field in port.__dataclass_fields__:
        assert getattr(port, field) == getattr(ref, field), field


@pytest.mark.parametrize("raw,want", [(None, 8), ("3", 3), ("0", 1),
                                      ("-4", 1), ("deep", 8)])
def test_pipeline_depth_reader(monkeypatch, raw, want):
    """``DBMT_PIPELINE_DEPTH`` as the JAX miner reads its twin (the
    default 8, at least 1), and the miner CLI hands it to the worker."""
    if raw is None:
        monkeypatch.delenv("DBMT_PIPELINE_DEPTH", raising=False)
    else:
        monkeypatch.setenv("DBMT_PIPELINE_DEPTH", raw)
    assert config.pipeline_depth_from_env() == want


class _Server:
    """Records the scheduler's writes as Messages."""

    def __init__(self):
        self.writes = []

    def write(self, conn_id, payload):
        from distributed_bitcoinminer_tpu_torch.bitcoin.message import \
            Message
        self.writes.append((conn_id, Message.from_json(payload)))

    def close_conn(self, conn_id):
        pass


def test_chip_smoke_reads_the_chunk_plans(tmp_path, caplog):
    """The scheduler's plan and adapt lines as ``chip_smoke.py`` reads
    them: an elephant activated after the chunk seconds moved is planned
    from the moved value, every planned chunk served is found, and the
    check fails on a chunk not served or a plan from another value."""
    import logging

    import chip_smoke
    from distributed_bitcoinminer_tpu_torch.apps.scheduler import Scheduler
    from distributed_bitcoinminer_tpu_torch.bitcoin.hash import hash_op
    from distributed_bitcoinminer_tpu_torch.bitcoin.message import (
        MsgType, new_request, new_result)
    caplog.set_level(logging.INFO, logger="dbmt")
    server = _Server()
    chunk_s = float(chip_smoke.MICE_SERVER_ENV["DBMT_QOS_CHUNK_S"])
    sched = Scheduler(
        server, qos=config.QosParams(chunk_s=chunk_s, wholesale_s=0.01,
                                     depth=2),
        coalesce=config.CoalesceParams(enabled=False),
        verify=config.VerifyParams(audit_p=0.0),
        stripe=config.StripeParams(enabled=False),
        cache=config.CacheParams(enabled=False), adapt=config.AdaptParams())
    sched.miner_plane.pool_rate = 1e5
    sched.miner_plane.observe_result = lambda m, c: None
    miners = (101, 102)
    for m in miners:
        sched._on_join(m)

    def serve(tenant, data):
        sched._on_request(tenant, new_request(data, 0, 9_999))
        while any(mn.pending for mn in sched.miners):
            mn = next(mn for mn in sched.miners if mn.pending)
            c = mn.pending[0]
            sched._on_result(mn.conn_id, new_result(
                hash_op(c.data, c.lower), c.lower, 0))

    serve(1, "elephant one")
    moved = 0.02
    sched.adapt_plane.tick = lambda *a, **k: {"chunk_s": moved}
    sched.adapt_plane.state = lambda: {"chunk_s": moved,
                                       "chunk_adjustments": 1}
    sched._apply_adapt()
    assert sched.qos.chunk_s == moved
    serve(2, "elephant two")
    server_log, miner_log = tmp_path / "log.txt", tmp_path / "miner.log"
    server_log.write_text("".join(f"00:00:00.000 {r.name} I "
                                  f"{r.getMessage()}\n"
                                  for r in caplog.records))
    served = [f"00:00:00.000 dbmt.miner I served {m.data!r} [{m.lower}, "
              f"{m.upper}] in 0.001s, busy 0.001s\n"
              for conn, m in server.writes
              if conn in miners and m.type == MsgType.REQUEST]
    miner_log.write_text("".join(served))
    run = {"tag": "cpu", "server_log": str(server_log),
           "miner_logs": [str(miner_log)]}
    assert chip_smoke.check_chunk_plans(run) == {
        "plans": 2, "multi_chunk": 2, "after_move": 1,
        "multi_chunk_after_move": 1}
    assert len(served) == 2 + 5       # 10^4 nonces at 5,000, then 2,000
    miner_log.write_text("".join(served[:-1]))
    with pytest.raises(SystemExit, match="not served"):
        chip_smoke.check_chunk_plans(run)
    miner_log.write_text("".join(served))
    server_log.write_text(server_log.read_text().replace(
        '"chunk_s": 0.02', '"chunk_s": 0.05'))
    with pytest.raises(SystemExit, match="chunk seconds in force"):
        chip_smoke.check_chunk_plans(run)
