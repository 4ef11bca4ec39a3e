"""The port's difficulty mode and device-resident chain against the JAX
package and the hashlib oracle, bit for bit.

Inputs come from fixed numpy seeds at small sizes (windows of at most a
few thousand lanes); every comparison is exact equality of uint32 words.
The port runs its plain PyTorch versions on the CPU; the JAX side runs
its jnp tier, and its Pallas K2 in interpret mode, on the CPU. K2 and K6
themselves run only on a card (``gpu`` marker; ``chip_smoke.py`` holds
them against the plain versions there).
"""

import asyncio
import functools
import logging
import time

import numpy as np
import pytest
import torch

from distributed_bitcoinminer_tpu.apps.miner import HostSearcher
from distributed_bitcoinminer_tpu.apps.miner import \
    MinerWorker as RefMinerWorker
from distributed_bitcoinminer_tpu.bitcoin.hash import (MAX_U64, hash_op,
                                                       scan_min, scan_until)
from distributed_bitcoinminer_tpu.models.miner_model import \
    NonceSearcher as RefSearcher
from distributed_bitcoinminer_tpu.ops import searchop as ref_searchop
from distributed_bitcoinminer_tpu.ops.search import search_span_until
from distributed_bitcoinminer_tpu_torch.apps import client as port_client
from distributed_bitcoinminer_tpu_torch.apps.client import (stream_until,
                                                            submit_until)
from distributed_bitcoinminer_tpu_torch.apps.miner import MinerWorker
from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
from distributed_bitcoinminer_tpu_torch.models import miner_model
from distributed_bitcoinminer_tpu_torch.ops import search, searchop
from distributed_bitcoinminer_tpu_torch.ops import sha256_cuda
from tests.test_torch_apps import Cluster, cpu_factory, fast_params
from tests.test_torch_ops import message_for, plan

M32 = 0xFFFFFFFF

# (rem, k): 1-block tails, then 2-block tails (rem + k > 55).
UNTIL_GRID = [(0, 1), (31, 9), (55, 9), (62, 5)]
TARGETS = ("mid_window", "dense", "miss")


def _window(k: int):
    """(i0, lo_i, hi_i, batch, nbatches) of a test window for k digits."""
    if k == 1:
        return 0, 1, 8, 8, 2
    i0 = 20_000 if k == 5 else 123_000_000
    return i0, i0 + 7, i0 + 2_000, 256, 8


@functools.lru_cache(maxsize=None)
def _until_case(rem: int, k: int):
    """The seeded message, its plan, its window and its three targets:
    one hitting at the window's arg-min lane (inside the window), one
    that about half the lanes satisfy, one that nothing satisfies."""
    data = message_for(rem, seed=2000 + rem * 16 + k)
    _, mid, tmpl, got_rem = plan(data, k)
    assert got_rem == rem and tmpl.shape[0] == (2 if rem + k > 55 else 1)
    i0, lo_i, hi_i, batch, nbatches = _window(k)
    hashes = [hash_op(data, n) for n in range(lo_i, hi_i + 1)]
    targets = {"mid_window": min(hashes) + 1,
               "dense": sorted(hashes)[len(hashes) // 2],
               "miss": min(hashes)}
    return data, mid, tmpl, (i0, lo_i, hi_i, batch, nbatches), targets


def _words(t) -> list:
    return [int(x) & M32 for x in (t.tolist() if hasattr(t, "tolist")
                                   else t)]


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("rem,k", UNTIL_GRID)
def test_span_until_scan_equals_jax_search_span_until(rem, k, target):
    data, mid, tmpl, (i0, lo_i, hi_i, batch, nbatches), targets = \
        _until_case(rem, k)
    t = targets[target]
    want = _words(search_span_until(
        np.asarray(mid, np.uint32), tmpl, np.uint32(i0), np.uint32(lo_i),
        np.uint32(hi_i), np.uint32(t >> 32), np.uint32(t & M32), None,
        rem=rem, k=k, batch=batch, nbatches=nbatches))
    # The port's steps are cut differently from the JAX batches: found
    # and f_idx cannot depend on that, best_* only counts when found is 0.
    got = _words(search.span_until_scan(
        mid, tmpl, i0, lo_i, hi_i, batch * nbatches, t >> 32, t & M32,
        rem=rem, k=k, device="cpu", chunk=100))
    assert got[:2] == want[:2]
    assert got[0] == (target != "miss")
    if not got[0]:
        assert got[2:] == want[2:]
    # The hashlib oracle over the same nonces (k digits, no top digits).
    o_hash, o_nonce, o_found = scan_until(data, lo_i, hi_i, t)
    assert o_found == bool(got[0])
    if o_found:
        assert got[1] == o_nonce and hash_op(data, got[1]) == o_hash
        if target == "mid_window":
            assert lo_i < got[1]
    else:
        assert (got[2] << 32 | got[3], got[4]) == (o_hash, o_nonce)


def test_span_until_scan_equals_pallas_interpret():
    """The Pallas K2 in interpret mode, rows=1, nsteps=2, in the geometry
    tests/test_torch_ops.py uses for K1."""
    from distributed_bitcoinminer_tpu.ops.sha256_pallas import \
        pallas_search_span_until
    data = "pallas parity"
    _, mid, tmpl, rem = plan(data, 5)
    i0, lo_i, hi_i = 20_000, 20_007, 20_200
    t = sorted(hash_op(data, n) for n in range(lo_i, hi_i + 1))[20]
    want = _words(pallas_search_span_until(
        np.asarray(mid, np.uint32), tmpl, np.uint32(i0), np.uint32(lo_i),
        np.uint32(hi_i), np.uint32(t >> 32), np.uint32(t & M32), rem=rem,
        k=5, rows=1, nsteps=2, interpret=True))
    got = _words(search.span_until_scan(mid, tmpl, i0, lo_i, hi_i, 256,
                                        t >> 32, t & M32, rem=rem, k=5,
                                        device="cpu", chunk=128))
    assert want[0] == 1 and got[:2] == want[:2]
    assert got[1] == scan_until(data, lo_i, hi_i, t)[1]


def _random_fold_args(rng, until: bool):
    """One seeded fold's arguments: a sentinel now and then, bases whose
    low word wraps when the lane is added, hits in any order."""
    base = int(rng.choice([0, 10 ** 9, (1 << 32) - 5, 3 << 32,
                           int(rng.integers(0, 1 << 62))]))
    if rng.random() < 0.2:
        m = (M32, M32, M32)
    else:
        m = (int(rng.integers(0, 4)), int(rng.integers(0, 3)),
             int(rng.integers(0, 1 << 32)))
    args = list(m) + [base >> 32, base & M32]
    if until:
        f = M32 if rng.random() < 0.5 else int(rng.integers(0, 1 << 32))
        args = [f] + args
    return args


@pytest.mark.parametrize("until", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_folds_equal_jax_searchop(seed, until):
    """Seeded fold sequences: every carry word after every fold, and the
    decodes, equal the JAX package's ops/searchop.py."""
    rng = np.random.default_rng(seed)
    op, ref_op = ((searchop.UNTIL_OP, ref_searchop.UNTIL_OP) if until
                  else (searchop.ARGMIN_OP, ref_searchop.ARGMIN_OP))
    carry, ref = op.init(), ref_op.init()
    assert _words(carry) == _words(ref)
    assert op.carry_words == ref_op.carry_words and op.nbytes == ref_op.nbytes
    for _ in range(24):
        args = _random_fold_args(rng, until)
        carry = op.fold(carry, *args)
        ref = ref_op.fold(ref, *(np.uint32(a) for a in args))
        assert _words(carry) == _words(np.asarray(ref))
        assert op.decode(carry, 7) == ref_op.decode(np.asarray(ref), 7)


def test_fold_edge_cases_equal_jax_searchop():
    """The sentinel never enters; a valid all-ones hash does; base + idx
    carries into the high word; a qualifying nonce folded out of order
    replaces a higher one and never a lower one."""
    cases = [
        ("argmin", [(M32, M32, M32, 0, 0)]),
        ("argmin", [(M32, M32, 5, 0, 0), (M32, M32, 4, 0, 0)]),
        ("argmin", [(7, 7, 9, 0, M32 - 3)]),
        ("until", [(M32, 3, 3, 3, 1, 0), (40, 1, 1, 1, 0, 0)]),
        ("until", [(100, 5, 5, 5, 2, 0), (7, 9, 9, 9, 1, M32),
                   (M32, 1, 1, 1, 0, 0), (3, 0, 0, 0, 1, M32)]),
    ]
    for name, folds in cases:
        op = searchop.UNTIL_OP if name == "until" else searchop.ARGMIN_OP
        ref_op = (ref_searchop.UNTIL_OP if name == "until"
                  else ref_searchop.ARGMIN_OP)
        carry, ref = op.init(), ref_op.init()
        for args in folds:
            carry = op.fold(carry, *args)
            ref = ref_op.fold(ref, *(np.uint32(a) for a in args))
            assert _words(carry) == _words(np.asarray(ref)), (name, args)
        assert op.decode(carry, 11) == ref_op.decode(np.asarray(ref), 11)
    # The 64-bit carry: lane 4 above base (1 << 32) - 2 is 2^32 + 2.
    n_hi, n_lo = searchop.global_nonce(torch.tensor(0), torch.tensor(M32 - 1),
                                       torch.tensor(4))
    assert (int(n_hi), int(n_lo)) == (1, 2)
    for a, b in (([1, 2, 3], [1, 2, 4]), ([2, 0], [1, 9]), ([5], [5])):
        assert bool(searchop.lex_less(torch.tensor(a), torch.tensor(b))) \
            == bool(ref_searchop.lex_less(np.uint32(a), np.uint32(b)))


def test_chained_until_after_a_hit_does_no_work():
    """A found carry passes a devloop until block unchanged (and would
    not be scanned at all): the plain form of K6's early return."""
    _, mid, tmpl, rem = plan("chained", 4)
    carry = torch.tensor([1, 0, 77, 5, 5, 0, 80, 1], dtype=torch.int64)
    out = search.devloop_span_until(mid, tmpl, carry.clone(), 0, 1000, 9999,
                                    9000, M32, M32, 10_000, rem=rem, k=4,
                                    device="cpu")
    assert out.tolist() == carry.tolist()


UNTIL_RANGES = [
    # (name, data, lower, upper, target)
    ("first_qualifying", "difficulty", 0, 4095, 1 << 59),
    ("miss_falls_back_to_argmin", "no luck", 100, 1500, 1),
    ("crosses_digit_classes", "cmu440", 0, 99_999, 1 << 56),
    ("one_nonce_max_target", "edge", 7, 7, MAX_U64),
    ("two_block_tail", "y" * 60, 9_950, 10_100, 1 << 60),
    ("hit_past_2_32", "cmu440", 4_294_967_290, 4_294_968_500, 1 << 57),
    ("miss_across_a_block_boundary", "cmu440", 1_999_999_500,
     2_000_000_400, 1),
    ("hit_in_the_second_block", "cmu440", 1_999_999_950, 2_000_000_800,
     1 << 58),
]
HIT_RANGES = [r for r in UNTIL_RANGES if not r[0].startswith("miss")]


@pytest.mark.parametrize("name,data,lower,upper,target", UNTIL_RANGES)
def test_search_until_equals_scan_until(name, data, lower, upper, target):
    """The chain answers the oracle's first qualifying nonce, or its
    arg-min on a miss, with one launch per block."""
    sha256_cuda.reset_launches()
    s = NonceSearcher(data, device="cpu")
    want = scan_until(data, lower, upper, target)
    assert want[2] == (not name.startswith("miss"))
    assert s.search_until(lower, upper, target) == want
    assert s.device_launches == len(list(s.plan(lower, upper)))
    assert sha256_cuda.total_launches() == 0


@pytest.mark.parametrize("name,data,lower,upper,target", HIT_RANGES)
def test_search_until_does_no_lane_work_after_the_hit(
        name, data, lower, upper, target, monkeypatch):
    """The blocks after the one that holds the first hit are chained but
    scan no lane: the plain form of K6's early return."""
    scanned = []
    plain = search.span_until_scan

    def counting(*args, **kwargs):
        scanned.append(args[2:4])
        return plain(*args, **kwargs)
    monkeypatch.setattr(search, "span_until_scan", counting)
    s = NonceSearcher(data, device="cpu")
    _, nonce, found = s.search_until(lower, upper, target)
    blocks = list(s.plan(lower, upper))
    hit_block = next(j for j, p in enumerate(blocks)
                     if p.base + p.lo_i <= nonce <= p.base + p.hi_i)
    assert found and len(scanned) == hit_block + 1
    assert s.device_launches == len(blocks)


@pytest.mark.parametrize("lower,upper,blocks", [(9_000, 10_300, 2),
                                                (1_999_999_900,
                                                 2_000_000_100, 2)])
def test_search_one_launch_per_block_one_carry(lower, upper, blocks):
    """An arg-min span is one launch per block folding into one 5-word
    carry, the handle ``finalize`` fetches once."""
    s = NonceSearcher("cmu440", device="cpu")
    carry = s.dispatch(lower, upper)
    assert carry.shape == (searchop.CARRY_WORDS,)
    assert s.device_launches == blocks == len(list(s.plan(lower, upper)))
    assert s.finalize(carry, lower) == scan_min("cmu440", lower, upper)


@pytest.mark.parametrize("name,data,lower,upper,target", UNTIL_RANGES[:2])
def test_search_until_equals_jax_searcher(name, data, lower, upper, target,
                                          monkeypatch):
    """The JAX searcher's stock until path (jnp tier), on the hit and the
    miss ranges. Its batch is wide enough that every block is one step, so
    it compiles one signature per (rem, k) it reaches, which keeps this
    file inside its CPU time budget; the oracle pins the other ranges."""
    monkeypatch.delenv("DBM_DEVLOOP_UNTIL", raising=False)
    ref = RefSearcher(data, batch=16384, tier="jnp", hoist=False)
    got = NonceSearcher(data, device="cpu").search_until(lower, upper, target)
    assert got == ref.search_until(lower, upper, target)


# ----------------------------------------------------------- no fallback

def test_until_and_fold_wrappers_refuse_cpu():
    _, mid, tmpl, rem = plan("no fallback", 2)
    sha256_cuda.reset_launches()
    with pytest.raises(ValueError):
        sha256_cuda.sha256_until(mid, tmpl, 0, 0, 99, 100, 1, 0, rem=rem,
                                 k=2, device="cpu")
    with pytest.raises(ValueError):
        sha256_cuda.sha256_argmin_fold(mid, tmpl, searchop.carry_init(), 0,
                                       0, 99, 100, 0, rem=rem, k=2,
                                       device="cpu")
    with pytest.raises(ValueError):
        sha256_cuda.sha256_until_fold(mid, tmpl, searchop.until_carry_init(),
                                      0, 0, 99, 100, 1, 0, 0, rem=rem, k=2,
                                      device="cpu")
    with pytest.raises(ValueError):   # a CPU carry for a CUDA launch
        sha256_cuda.sha256_until_fold(mid, tmpl, searchop.until_carry_init(),
                                      0, 0, 99, 100, 1, 0, 0, rem=rem, k=2,
                                      device="cuda")
    for router, args in ((search.span_until, (1, 0)),
                         (search.devloop_span,
                          (searchop.carry_init(),)),
                         (search.devloop_span_until,
                          (searchop.until_carry_init(),))):
        with pytest.raises(ValueError):
            if router is search.span_until:
                router(mid, tmpl, 0, 0, 9, 10, *args, rem=rem, k=2,
                       device="meta")
            elif router is search.devloop_span:
                router(mid, tmpl, *args, 0, 0, 9, 10, 0, rem=rem, k=2,
                       device="meta")
            else:
                router(mid, tmpl, *args, 0, 0, 9, 10, 1, 0, 0, rem=rem, k=2,
                       device="meta")
    assert sha256_cuda.total_launches() == 0


@pytest.mark.parametrize("entry", ["search", "search_until"])
def test_kernel_failure_propagates_out_of_the_searcher(entry, monkeypatch):
    """A failing kernel call raises out of the searcher; nothing answers
    from the CPU or the plain version instead."""
    def boom(*args, **kwargs):
        raise RuntimeError("dbmt_sha256_until_fold launch failed: "
                           "cudaError 700")
    monkeypatch.setattr(miner_model, "devloop_span", boom)
    monkeypatch.setattr(miner_model, "devloop_span_until", boom)
    s = NonceSearcher("broken", device="cpu")
    with pytest.raises(RuntimeError, match="cudaError 700"):
        if entry == "search":
            s.search(0, 999)
        else:
            s.search_until(0, 999, 1 << 60)


# ------------------------------------------------------------ end to end

def until_cpu_factory(delay: float = 0.0):
    """The port's searcher on the CPU, its difficulty mode optionally
    slowed down."""
    def make(data):
        s = cpu_factory()(data)
        if delay:
            until = s.search_until

            def slow(lower, upper, target):
                time.sleep(delay)
                return until(lower, upper, target)
            s.search_until = slow
        return s
    return make


class _ArgminOnly:
    """A searcher without difficulty mode (a stock miner's shape)."""

    def __init__(self, data):
        self._s = NonceSearcher(data, device="cpu")

    def search(self, lower, upper):
        return self._s.search(lower, upper)


def test_three_miners_answer_the_first_qualifying_nonce():
    data, max_nonce, target = "threaded target", 2999, 1 << 58
    want = scan_until(data, 0, max_nonce + 1, target)
    assert want[2]

    async def scenario():
        async with Cluster(fast_params()) as c:
            miners = [await c.start_miner() for _ in range(3)]
            got = await asyncio.wait_for(
                submit_until(c.hostport, data, max_nonce, target, c.params),
                30)
            assert got == want
            assert not c.scheduler.stats["claims_failed"]
            assert all(m.counts()["kernel_launches"] == {
                "K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0,
                "K6mesh": 0}
                       for m in miners)
    asyncio.run(scenario())


def test_unreachable_target_gives_the_exact_argmin():
    async def scenario():
        async with Cluster(fast_params()) as c:
            for _ in range(2):
                await c.start_miner()
            got = await asyncio.wait_for(
                submit_until(c.hostport, "impossible", 1499, 1, c.params),
                30)
            assert got == (*scan_min("impossible", 0, 1500), False)
    asyncio.run(scenario())


def test_miners_without_until_give_a_weak_merge(caplog):
    data, max_nonce, target = "mixed pool", 2999, 1 << 58

    async def scenario():
        async with Cluster(fast_params()) as c:
            for _ in range(2):
                await c.start_miner(_ArgminOnly)
            got = await asyncio.wait_for(
                submit_until(c.hostport, data, max_nonce, target, c.params),
                30)
            g_hash, g_nonce, found = got
            assert found and g_hash < target
            assert g_hash == hash_op(data, g_nonce)
    with caplog.at_level(logging.INFO, logger="dbmt.scheduler"):
        asyncio.run(scenario())
    records = [r.getMessage() for r in caplog.records
               if r.name == "dbmt.scheduler"]
    assert any("without the target extension" in m for m in records)
    assert any("(weak merge)" in m for m in records)


def test_target_chunk_survives_a_miner_drop():
    data, max_nonce, target = "fault target", 2399, 1 << 58
    want = scan_until(data, 0, max_nonce + 1, target)
    assert want[2]

    async def scenario():
        params = fast_params(epoch_ms=40, limit=3)
        async with Cluster(params) as c:
            victim = await c.start_miner(until_cpu_factory(delay=1.5))
            await c.start_miner()
            pending = asyncio.create_task(
                submit_until(c.hostport, data, max_nonce, target, params))
            await asyncio.sleep(0.3)   # both miners hold target chunks
            victim.client._conn.abort()
            victim.client._ep.close()
            assert await asyncio.wait_for(pending, 30) == want
    asyncio.run(scenario())


def test_prefix_release_does_not_wait_for_slow_chunks(caplog):
    """Only chunk 0 can hit: its answer is released while the slow
    miners still hold chunks 1 and 2."""
    data, max_nonce, slow = "chunk zero", 2999, 1.5
    # Chunks (3 miners): [0,1000], [1000,2000], [2000,3000] inclusive.
    target = min(hash_op(data, n) for n in range(1000, 3001))
    want = scan_until(data, 0, max_nonce + 1, target)
    assert want[2] and want[1] <= 1000

    async def scenario():
        async with Cluster(fast_params()) as c:
            await c.start_miner()   # join order is chunk order
            for _ in range(2):
                await c.start_miner(until_cpu_factory(delay=slow))
            t0 = time.monotonic()
            got = await asyncio.wait_for(
                submit_until(c.hostport, data, max_nonce, target, c.params),
                30)
            assert got == want
            assert time.monotonic() - t0 < slow * 0.6
    with caplog.at_level(logging.INFO, logger="dbmt.scheduler"):
        asyncio.run(scenario())
    assert any("(prefix release)" in r.getMessage() for r in caplog.records)


def test_prefix_release_waits_for_an_earlier_chunk():
    """A hit in chunk 1 that arrives first must not release: chunk 0 also
    hits, at a lower nonce."""
    data, max_nonce, target = "early exit", 2999, 1 << 59
    want = scan_until(data, 0, max_nonce + 1, target)
    later = scan_until(data, 1500, 3000, target)
    assert want[2] and want[1] <= 1000 and later[2]

    async def scenario():
        async with Cluster(fast_params()) as c:
            await c.start_miner(until_cpu_factory(delay=0.8))
            await c.start_miner()
            got = await asyncio.wait_for(
                submit_until(c.hostport, data, max_nonce, target, c.params),
                30)
            assert got == want
    asyncio.run(scenario())


def test_stream_until_end_to_end():
    async def scenario():
        async with Cluster(fast_params()) as c:
            await c.start_miner()
            target = 1 << 57
            got = await asyncio.wait_for(
                stream_until(c.hostport, "stream", target, span=500,
                             params=c.params), 30)
            g_hash, g_nonce, spans = got
            assert g_hash < target and g_hash == hash_op("stream", g_nonce)
            lo = (spans - 1) * 500
            assert lo <= g_nonce <= spans * 500
            assert all(hash_op("stream", n) >= target for n in range(lo))
    asyncio.run(scenario())


def test_client_cli_takes_a_target(capsys):
    data, max_nonce, target = "cli target", 1999, 1 << 58
    want = scan_until(data, 0, max_nonce + 1, target)
    assert want[2]

    async def scenario():
        async with Cluster(fast_params()) as c:
            await c.start_miner()
            return await asyncio.wait_for(asyncio.to_thread(
                port_client.main, ["client", c.hostport, data,
                                   str(max_nonce), str(target)]), 30)
    assert asyncio.run(scenario()) == 0
    assert capsys.readouterr().out.strip() == f"Result {want[0]} {want[1]}"
    assert port_client.main(["client", "h:1", "msg", "5", "+1"]) == 1
    assert "+1 is not a number." in capsys.readouterr().out
    assert port_client.main(["client", "h:1", "msg", "5", "1", "2"]) == 1


def test_port_until_miners_under_jax_scheduler():
    from distributed_bitcoinminer_tpu.apps.client import \
        submit_until as ref_submit_until
    data, max_nonce, target = "interop target", 2999, 1 << 58
    want = scan_until(data, 0, max_nonce + 1, target)
    assert want[2]

    async def scenario():
        async with Cluster(fast_params(), ref_scheduler=True) as c:
            for _ in range(2):
                await c.start_miner()
            got = await asyncio.wait_for(
                ref_submit_until(c.hostport, data, max_nonce, target,
                                 c.params), 30)
            assert got == want
            assert c.scheduler.stats["claims_failed"] == 0
    asyncio.run(scenario())


def test_jax_until_miners_under_port_scheduler(caplog):
    data, max_nonce, target = "interop until", 2999, 1 << 58
    want = scan_until(data, 0, max_nonce + 1, target)
    assert want[2]

    async def scenario():
        async with Cluster(fast_params()) as c:
            for _ in range(2):
                await c.start_miner(worker=RefMinerWorker(
                    c.hostport, params=c.params, pipeline=False,
                    searcher_factory=lambda d, batch: HostSearcher(d)))
            got = await asyncio.wait_for(
                submit_until(c.hostport, data, max_nonce, target, c.params),
                30)
            assert got == want
    with caplog.at_level(logging.INFO, logger="dbmt.scheduler"):
        asyncio.run(scenario())
    assert not any("without the target extension" in r.getMessage()
                   for r in caplog.records)


def test_miner_exits_when_search_until_fails_and_chunk_is_reassigned():
    class Broken:
        def search(self, lower, upper):
            raise AssertionError("a target chunk must not fall back to "
                                 "search")

        def search_until(self, lower, upper, target):
            raise RuntimeError("dbmt_sha256_until launch failed")

    data, max_nonce, target = "broken until", 799, 1 << 58
    want = scan_until(data, 0, max_nonce + 1, target)

    async def scenario():
        params = fast_params(epoch_ms=40, limit=3)
        async with Cluster(params) as c:
            await c.start_miner(lambda d: Broken())
            pending = asyncio.create_task(
                submit_until(c.hostport, data, max_nonce, target, params))
            await asyncio.sleep(0.5)
            await c.start_miner()
            assert await asyncio.wait_for(pending, 30) == want
    asyncio.run(scenario())


def test_miner_echoes_the_target_only_when_it_ran_until():
    w = MinerWorker("127.0.0.1:1", searcher_factory=cpu_factory())
    h, n, echo = w._search("echo", 0, 500, 1 << 60)
    assert (h, n, True) == scan_until("echo", 0, 500, 1 << 60) and \
        echo == 1 << 60
    w = MinerWorker("127.0.0.1:1", searcher_factory=_ArgminOnly)
    assert w._search("echo", 0, 500, 1 << 60) == \
        (*scan_min("echo", 0, 500), 0)


# ------------------------------------------------------------ on the card

@pytest.mark.gpu
def test_until_and_chain_kernels_equal_plain_on_card():
    """K2 and K6 against their plain versions on the card: found and
    f_idx always, best_* when found is 0, carries word for word."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run chip_smoke.py on the GPU)")
    dev = torch.device("cuda", 0)
    for rem, k in UNTIL_GRID:
        _, mid, tmpl, (i0, lo_i, hi_i, batch, nbatches), targets = \
            _until_case(rem, k)
        n = batch * nbatches
        for t in targets.values():
            want = _words(search.span_until_scan(
                mid, tmpl, i0, lo_i, hi_i, n, t >> 32, t & M32, rem=rem,
                k=k, device=dev))
            for grid in (None, 3):
                got = _words(sha256_cuda.sha256_until(
                    mid, tmpl, i0, lo_i, hi_i, n, t >> 32, t & M32, rem=rem,
                    k=k, device=dev, grid=grid))
                assert got[:2] == want[:2]
                if not got[0]:
                    assert got == want
    s = NonceSearcher("cmu440", device="cpu")
    plans = [next(iter(s.plan(b * 10 ** 9 + 500, b * 10 ** 9 + 4_000)))
             for b in range(4, 8)]
    for until in (False, True):
        op = searchop.UNTIL_OP if until else searchop.ARGMIN_OP
        carry_k, carry_p = search.devloop_carry(op, dev), op.init()
        for p in plans:
            args = (p.lo_i, p.lo_i, p.hi_i, p.lanes)
            args += (1 << 26, 0, p.base) if until else (p.base,)
            step = search.devloop_span_until if until else search.devloop_span
            carry_k = step(p.midstate, p.template, carry_k, *args, rem=p.rem,
                           k=p.k, device=dev)
            carry_p = step(p.midstate, p.template, carry_p, *args, rem=p.rem,
                           k=p.k, device="cpu")
            got, want = _words(carry_k), _words(carry_p)
            if until and want[0]:
                assert got[:3] == want[:3]
            else:
                assert got == want
