"""The port's verification tier against the JAX package's, in lockstep.

The rig of ``tests/test_torch_lease.py``: the port's scheduler and the
JAX ``Scheduler`` fed the same events over recording fake servers, one
fake clock, and seeded ``random.Random`` audit streams with the same
seed, so both draw the same audits and windows. After every event both
have written the same messages and hold the same counters, miners (trust
included) and outstanding audits. The cases mirror
``tests/test_verify.py``'s unit tier, playing honest and lying miners by
hand; two seeded byzantine storms drive liars scripted by the port's
``ByzantineSearcher`` over the ``bitcoin.hash`` oracle, and every reply
must equal ``scan_min``. Plus ``verify_from_env`` against the JAX reader.
"""

import threading

import numpy as np
import pytest

from distributed_bitcoinminer_tpu.bitcoin.hash import scan_min
from distributed_bitcoinminer_tpu.utils import config as ref_config
from distributed_bitcoinminer_tpu_torch.bitcoin.hash import (hash_op,
                                                             scan_until)
from distributed_bitcoinminer_tpu_torch.lspnet.chaos import \
    ByzantineSearcher
from distributed_bitcoinminer_tpu_torch.utils import config
from tests.test_torch_lease import (CLIENT_X, MINER_A, MINER_B, MINER_C,
                                    Pair, clock)  # noqa: F401  (fixture)

AUDIT_ALL = {"audit_p": 1.0, "audit_max_nonces": 1 << 20}


def sentinel(chunk):
    """A real pair that is not scanned: the hash of the first nonce."""
    return hash_op(chunk.data, chunk.lower), chunk.lower


def test_honest_claim_accepted_and_counted(clock):
    p = Pair(verify={})
    p.join(MINER_A)
    p.request(CLIENT_X, "honest work", 99)
    p.answer(MINER_A)
    assert p.replies(CLIENT_X) == [scan_min("honest work", 0, 100)]
    assert p.port.stats["claims_checked"] == 1
    assert p.port.stats["claims_failed"] == 0
    assert p.miner(MINER_A).trust == 1.0


def test_fabricated_hash_rejected_and_regranted(clock):
    p = Pair()
    p.join(MINER_A)
    p.join(MINER_B)
    p.request(CLIENT_X, "audit storm", 199)
    (lo0, hi0), (lo1, hi1) = p.requests_to(MINER_A)[0], \
        p.requests_to(MINER_B)[0]
    p.result(MINER_A, 1, lo0)            # hash_op != 1
    assert p.replies(CLIENT_X) == []
    assert p.port.stats["claims_failed"] == 1
    assert p.port.stats["trust_decays_claim"] == 1
    assert p.miner(MINER_A).trust == pytest.approx(0.25)
    assert len(p.port.miner_plane.parked) == 1    # B is busy: it parks
    p.answer(MINER_B)                    # B's own; absorbs the park
    assert p.requests_to(MINER_B) == [(lo1, hi1), (lo0, hi0)]
    p.answer(MINER_B)
    assert p.replies(CLIENT_X) == [scan_min("audit storm", 0, 200)]


def test_real_pair_outside_range_rejected(clock):
    p = Pair()
    p.join(MINER_A)
    p.join(MINER_B)
    p.request(CLIENT_X, "range theft", 199)
    lo0, hi0 = p.requests_to(MINER_A)[0]
    stolen = p.requests_to(MINER_B)[0][1]
    assert not lo0 <= stolen <= hi0
    p.result(MINER_A, hash_op("range theft", stolen), stolen)
    assert p.port.stats["claims_failed"] == 1
    assert p.replies(CLIENT_X) == []


@pytest.mark.parametrize("qos", [False, True], ids=["fifo", "qos"])
def test_difficulty_fabricated_qualifier_rejected(clock, qos):
    target = 1 << 40
    p = Pair(qos=qos)
    p.join(MINER_A)
    p.request(CLIENT_X, "fake gold", 99, target=target)
    lo, _ = p.requests_to(MINER_A)[0]
    p.result(MINER_A, 5, lo + 3, target)
    assert p.replies(CLIENT_X) == []
    assert p.port.stats["claims_failed"] == 1
    assert len(p.port.miner_plane.parked) == 1
    p.join(MINER_B)                      # the joiner absorbs it
    p.answer(MINER_B)
    assert p.replies(CLIENT_X) == [scan_until("fake gold", 0, 100,
                                              target)[:2]]


def test_audit_catches_sentinel_and_repairs_reply(clock):
    data = "audit storm"                 # its arg-min lies in chunk 0
    p = Pair(verify=AUDIT_ALL)
    p.join(MINER_A)
    p.join(MINER_B)
    p.request(CLIENT_X, data, 199)
    p.answer(MINER_A, sentinel)          # real, in range, not scanned
    assert p.port.stats["claims_failed"] == 0
    assert p.port.stats["audits_issued"] == 1     # on B
    p.answer(MINER_B)                    # B's own, audited on A
    assert p.port.stats["audits_issued"] == 2
    assert p.replies(CLIENT_X) == []
    p.answer(MINER_A)                    # A re-runs B's window honestly
    assert p.port.stats["audits_passed"] == 1
    assert p.replies(CLIENT_X) == []
    p.answer(MINER_B)                    # B re-runs A's: the lie caught
    assert p.port.stats["audits_failed"] == 1
    assert p.port.stats["trust_decays_audit"] == 1
    assert p.miner(MINER_A).trust == pytest.approx(0.25)
    assert p.replies(CLIENT_X) == [scan_min(data, 0, 200)]


def test_byzantine_auditor_cannot_launder_a_lie(clock):
    data = "audit storm"
    p = Pair(verify=AUDIT_ALL)
    for m in (MINER_A, MINER_B, MINER_C):
        p.join(m)
    p.request(CLIENT_X, data, 299)
    p.answer(MINER_A, sentinel)          # audited on B (ties: join order)
    assert p.port.stats["audits_issued"] == 1
    p.answer(MINER_B)
    p.answer(MINER_C)
    failed = p.port.stats["claims_failed"]
    p.answer(MINER_B, lambda c: (1, c.lower))     # B lies on the audit
    assert p.port.stats["claims_failed"] == failed + 1
    assert p.miner(MINER_B).trust < 1.0
    assert p.port.stats["audits_issued"] >= 4
    assert p.replies(CLIENT_X) == []
    for _ in range(8):
        if p.replies(CLIENT_X):
            break
        for m in p.busy():
            p.answer(m)
    assert p.replies(CLIENT_X) == [scan_min(data, 0, 300)]
    assert p.port.stats["audits_failed"] >= 1


def test_dead_auditor_releases_hold_as_inconclusive(clock):
    data = "spot check"
    p = Pair(verify=AUDIT_ALL)
    p.join(MINER_A)
    p.join(MINER_B)
    p.request(CLIENT_X, data, 199)
    p.answer(MINER_A)                    # audited on B
    p.answer(MINER_B)                    # audited on A
    assert p.port.stats["audits_issued"] == 2
    p.drop(MINER_B)                      # chunk 0's auditor dies
    assert p.port.stats["audits_inconclusive"] == 1
    assert p.replies(CLIENT_X) == []
    p.answer(MINER_A)
    assert p.port.stats["audits_passed"] == 1
    assert p.replies(CLIENT_X) == [scan_min(data, 0, 200)]


def test_expired_audit_goes_to_another_auditor(clock):
    """A wedged auditor's audit expires on the sweep and is issued to
    another disjoint miner."""
    data = "slow auditor"
    p = Pair(verify=AUDIT_ALL, grace_s=5.0)
    for m in (MINER_A, MINER_B, MINER_C):
        p.join(m)
    p.request(CLIENT_X, data, 299)
    p.answer(MINER_A)                    # audited on B (least loaded tie)
    issued = p.port.stats["audits_issued"]
    clock.step(100.0)
    p.sweep()                            # B's chunk and C's blow too
    assert p.port.stats["audits_issued"] > issued
    for _ in range(10):
        if p.replies(CLIENT_X):
            break
        for m in p.busy():
            p.answer(m)
        p.sweep()
    assert p.replies(CLIENT_X) == [scan_min(data, 0, 300)]


def test_trust_decay_recovery_curve_and_desperation(clock):
    p = Pair()
    p.join(MINER_A)
    mps = (p.port.miner_plane, p.ref.miner_plane)
    v = config.VerifyParams()
    for mp in mps:
        ms = mp.find_miner(MINER_A)
        assert mp.trust_fail(ms, "claim") == pytest.approx(0.25)
        assert not mp.distrusted(ms)
        assert mp.trust_fail(ms, "audit") == pytest.approx(0.0625)
        assert mp.distrusted(ms)
        for _ in range(10):
            mp.trust_fail(ms, "claim")
        assert ms.trust == v.trust_floor
    p.check()
    assert p.port.stats["trust_decays_claim"] == 11
    datas = [f"redemption {i}" for i in range(4)]
    seen = [p.miner(MINER_A).trust]
    for i, data in enumerate(datas):
        p.request(CLIENT_X, data, 99)
        p.answer(MINER_A)
        seen.append(p.miner(MINER_A).trust)
    assert p.port.stats["desperation_dispatch"] >= 1
    assert seen == sorted(seen)
    assert seen[-1] == pytest.approx(v.trust_floor + 4 * v.trust_recover)
    assert not p.port.miner_plane.distrusted(p.miner(MINER_A))
    assert p.replies(CLIENT_X) == [scan_min(d, 0, 100) for d in datas]


@pytest.mark.parametrize("qos", [False, True], ids=["fifo", "qos"])
def test_distrusted_miner_excluded_while_honest_pool_remains(clock, qos):
    p = Pair(qos=qos)
    p.join(MINER_A)
    p.join(MINER_B)
    for mp in (p.port.miner_plane, p.ref.miner_plane):
        liar = mp.find_miner(MINER_A)
        mp.trust_fail(liar, "claim")
        mp.trust_fail(liar, "claim")
    p.check()
    p.request(CLIENT_X, "clean hands", 99)
    assert p.requests_to(MINER_A) == []
    assert len(p.requests_to(MINER_B)) == 1
    p.answer(MINER_B)
    assert p.replies(CLIENT_X) == [scan_min("clean hands", 0, 100)]
    assert p.port.stats["desperation_dispatch"] == 0


def test_verify_off_believes_every_result(clock):
    p = Pair(verify={"enabled": False})
    p.join(MINER_A)
    p.request(CLIENT_X, "believed", 99)
    p.result(MINER_A, 1, 0)
    assert p.replies(CLIENT_X) == [(1, 0)]
    assert p.port.stats["claims_checked"] == 0


class Oracle:
    """An honest searcher over the hashlib oracle."""

    def __init__(self, data):
        self.data = data

    def search(self, lower, upper):
        return scan_until(self.data, lower, upper, 0)[:2]

    def search_until(self, lower, upper, target):
        return scan_until(self.data, lower, upper, target)


@pytest.mark.parametrize("qos", [False, True], ids=["fifo", "qos"])
@pytest.mark.parametrize("seed", [0, 1])
def test_byzantine_storm_never_answers_wrong(clock, seed, qos):
    """Honest miners beside one sentinel-class liar and wrong-hash liars,
    every arg-min chunk audited over its whole range, leases running:
    every reply equals the oracle, while the liars lose their trust."""
    rng = np.random.default_rng(seed)
    p = Pair(qos=qos, verify=AUDIT_ALL, seed=seed, grace_s=5.0,
             floor_s=0.5, qos_kw={"wholesale_s": 2.0, "chunk_s": 1.0}
             if qos else None)
    lie = threading.Event()
    lie.set()
    modes = {201: None, 202: None, 203: "wrong_hash",
             204: str(rng.choice(["sentinel", "selective"])),
             205: None, 206: "wrong_hash"}
    for m in modes:
        p.join(m)

    searchers = {}          # per miner and message, as a miner keeps

    def answer(m):
        c = p.head(m)
        s = searchers.get((m, c.data))
        if s is None:
            s = searchers[m, c.data] = Oracle(c.data) if modes[m] is None \
                else ByzantineSearcher(Oracle(c.data), c.data, modes[m], lie)
        if c.target:
            h, nonce, _ = s.search_until(c.lower, c.upper, c.target)
        else:
            h, nonce = s.search(c.lower, c.upper)
        p.result(m, h, nonce, c.target)

    asked = {}
    for step in range(140):
        r = rng.random()
        if r < 0.2:
            mx = int(rng.integers(0, 1 << 11))
            target = int(rng.choice([0, 0, 0, 1 << 58]))
            data = f"storm {seed}.{step}"
            t = 1000 + step
            p.request(t, data, mx, target)
            asked[t] = (data, mx, target)
        elif r < 0.8 and p.busy():
            busy = p.busy()
            answer(busy[int(rng.integers(0, len(busy)))])
        elif r < 0.9:
            clock.step(float(rng.choice([0.05, 0.3, 1.0])))
        else:
            p.sweep()
    for _ in range(500):
        if not (p.busy() or len(p.port.tenant_plane) or p.port.inflight):
            break
        for m in p.busy():
            if m in p.busy():
                answer(m)
        clock.step(0.05)
        p.sweep()
    for t, (data, mx, target) in asked.items():
        assert p.replies(t) == [scan_until(data, 0, mx + 1, target)[:2]], \
            (t, data, mx, target)
    liars = [m for m, mode in modes.items() if mode is not None]
    assert p.port.stats["claims_failed"] > 0
    assert p.port.stats["audits_failed"] > 0
    assert all(p.port.miner_plane.distrusted(p.miner(m)) for m in liars)
    assert all(p.miner(m).trust == 1.0 for m, mode in modes.items()
               if mode is None)


# ------------------------------------------------------------- env reader

VERIFY_KNOBS = {"AUDIT_P": "0.375", "AUDIT_MAX": "4096",
                "TRUST_DECAY": "0.5", "TRUST_RECOVER": "0.125",
                "TRUST_FLOOR": "0.0625", "TRUST_BAR": "0.25"}


def test_verify_from_env_equals_jax(monkeypatch):
    for k in VERIFY_KNOBS:
        monkeypatch.delenv("DBM_" + k, raising=False)
        monkeypatch.delenv("DBMT_" + k, raising=False)
    monkeypatch.delenv("DBM_VERIFY", raising=False)
    port, ref = config.verify_from_env(), ref_config.verify_from_env()
    assert vars(port) == vars(ref) and port.audit_p == 0.02
    assert vars(config.VerifyParams()) == vars(ref_config.VerifyParams())
    assert config.VerifyParams().audit_p == 0.0
    for k, v in VERIFY_KNOBS.items():
        monkeypatch.setenv("DBM_" + k, v)
        monkeypatch.setenv("DBMT_" + k, v)
    assert vars(config.verify_from_env()) == vars(ref_config.verify_from_env())
    for k, v in (("AUDIT_P", "7"), ("TRUST_DECAY", "0"), ("AUDIT_MAX", "-3"),
                 ("TRUST_RECOVER", "2"), ("TRUST_BAR", "-1")):
        monkeypatch.setenv("DBM_" + k, v)
        monkeypatch.setenv("DBMT_" + k, v)
    port = config.verify_from_env()
    assert vars(port) == vars(ref_config.verify_from_env())
    assert port.audit_p == 1.0 and port.audit_max_nonces == 1
