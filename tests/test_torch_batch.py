"""The port's batched dispatch against the JAX package, bit for bit.

- The plain segment-min (``segmin_rows``, ``span_segmin_scan``) against
  the JAX package's ``segmin_rows`` and ``search_span_segmin`` on the same
  rows, and against its K5 TPU kernel (``pallas_search_span_batch``) in
  interpret mode on a tiny case: mixed messages, ragged windows, an
  empty-window row, multi-row segments, ties.
- ``NonceSearcher.dispatch_batch``/``finalize_batch`` on the CPU against
  per-job ``search`` and the hashlib scan; ``None`` for searchers that
  cannot share a launch; an empty range raises.
- The pipelined coalescing miner on the CPU: Results in request order,
  difficulty and oversize chunks never coalesced, coalescing off equal to
  the serial path, a failing batched launch ends the miner instead of
  answering through another route; and end to end over localhost LSP
  under the port's scheduler and the JAX package's, mice of several
  tenants sharing launches while an elephant runs.

Inputs come from a numpy seed. The K5 CUDA kernel itself runs only on a
card (``gpu`` marker; ``chip_smoke.py`` holds it to the plain version).
"""

import asyncio

import numpy as np
import pytest
import torch

from distributed_bitcoinminer_tpu.apps.scheduler import \
    Scheduler as RefScheduler
from distributed_bitcoinminer_tpu.bitcoin.hash import scan_min, scan_until
from distributed_bitcoinminer_tpu.ops.search import \
    search_span_segmin as ref_search_span_segmin
from distributed_bitcoinminer_tpu.ops.search import \
    segmin_rows as ref_segmin_rows
from distributed_bitcoinminer_tpu.ops.sha256_pallas import \
    pallas_search_span_batch
from distributed_bitcoinminer_tpu.utils.config import \
    CoalesceParams as RefCoalesceParams
from distributed_bitcoinminer_tpu.utils.config import LeaseParams
from distributed_bitcoinminer_tpu.utils.config import \
    QosParams as RefQosParams
from distributed_bitcoinminer_tpu_torch.apps.miner import MinerWorker
from distributed_bitcoinminer_tpu_torch.bitcoin.message import (
    Message, MsgType, new_request)
from distributed_bitcoinminer_tpu_torch.lsp.client import new_async_client
from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
from distributed_bitcoinminer_tpu_torch.models import miner_model
from distributed_bitcoinminer_tpu_torch.ops import search, sha256_cuda
from distributed_bitcoinminer_tpu_torch.ops import sha256_host, sha256_torch
from distributed_bitcoinminer_tpu_torch.utils.config import (CoalesceParams,
                                                             QosParams)

from tests.test_torch_apps import Cluster, cpu_factory, fast_params

M32 = 0xFFFFFFFF


def _plan(data: str, k: int):
    prefix = data.encode() + b" "
    mid, tail = sha256_host.sha256_midstate(prefix)
    return mid, sha256_torch.build_tail_template(tail, k,
                                                 len(prefix) + k), len(tail)


# ------------------------------------------------------------ segment-min

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segmin_rows_equal_jax(seed):
    """Words with many (hi, lo) ties, sorted segment ids with gaps (empty
    segments) and sentinel rows: the three-pass lexicographic minimum
    equals the JAX package's."""
    rng = np.random.default_rng(seed)
    n, nseg = 40, 16
    hi = rng.integers(0, 3, n).astype(np.uint32)
    lo = rng.integers(0, 3, n).astype(np.uint32)
    idx = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    hi[::7] = lo[::7] = idx[::7] = M32
    seg = np.sort(rng.integers(0, nseg, n)).astype(np.int32)
    want = [np.asarray(x) for x in ref_segmin_rows(hi, lo, idx, seg, nseg)]
    got = search.segmin_rows(*(torch.from_numpy(a.astype(np.int64))
                               for a in (hi, lo, idx)), seg, nseg)
    for g, w in zip(got, want):
        assert g.tolist() == w.astype(np.int64).tolist()


#: Rows of two tail-block classes, each one JAX signature: messages of one
#: length share rem. (message, lower window edge, upper window edge, i0)
#: with the JAX shape's 1,024 lanes per row; a None window is empty.
_BATCH, _NBATCHES, _K = 256, 4, 5
_GROUPS = {
    "one_block": [("alpha", 3, 900, 0), ("gamma", 100, 1_000, 100),
                  ("alpha", 500, 700, 500), ("gamma", None, None, 0),
                  ("alpha", 2_048, 2_100, 1_100)],
    "two_block": [("m" * 56, 0, 1_023, 0), ("n" * 56, 77, 600, 50),
                  ("m" * 56, 1_024, 2_047, 1_024), ("n" * 56, None, None, 9)],
}
#: Segment ids per group: multi-row segments, the empty row alone.
_SEGS = {"one_block": [0, 0, 1, 2, 3], "two_block": [0, 0, 1, 2]}


def _group_rows(name):
    rows = []
    for data, lo, hi, i0 in _GROUPS[name]:
        mid, tmpl, rem = _plan(data, _K)
        if lo is None:
            lo, hi = i0 + 1, i0
        rows.append((mid, tmpl, i0, lo, hi, _BATCH * _NBATCHES, rem, _K))
    return rows


def test_span_segmin_scan_equal_jax_search_span_segmin():
    """One mixed port batch over both groups (1- and 2-block tails,
    several messages) against the JAX package's per-signature launches;
    each segment's (hi, lo, idx) bit for bit."""
    rows, seg, want = [], [], []
    for name in _GROUPS:
        g_rows, g_seg = _group_rows(name), _SEGS[name]
        base = seg[-1] + 1 if seg else 0
        rows += g_rows
        seg += [base + s for s in g_seg]
        r = ref_search_span_segmin(
            np.stack([np.asarray(x[0], np.uint32) for x in g_rows]),
            np.stack([x[1] for x in g_rows]),
            *(np.asarray([x[j] for x in g_rows], np.uint32)
              for j in (2, 3, 4)),
            np.asarray(g_seg, np.int32), rem=g_rows[0][6], k=_K,
            batch=_BATCH, nbatches=_NBATCHES)
        want += list(zip(*(np.asarray(x)[:g_seg[-1] + 1].tolist()
                           for x in r)))
    got = search.span_segmin_scan(rows, seg, device="cpu")
    assert got.shape == (3, seg[-1] + 1)
    assert [tuple(c) for c in got.T.tolist()] == want
    empty = [i for i, (h, l, x) in enumerate(want) if h == l == x == M32]
    assert empty == [2, 6]          # the two empty-window segments


def test_span_segmin_equal_pallas_batch_interpret():
    """The TPU kernel K5 (interpret mode, as the JAX package's tests run
    it) on two rows of two messages: equal to the port's plain version."""
    rows = []
    for data, i0, lo, hi in (("cmu440", 0, 3, 200), ("pallas", 100, 100,
                                                     300)):
        mid, tmpl, rem = _plan(data, _K)
        rows.append((mid, tmpl, i0, lo, hi, 1_024, rem, _K))
    assert rows[0][6] == rows[1][6]
    r = pallas_search_span_batch(
        np.stack([np.asarray(x[0], np.uint32) for x in rows]),
        np.stack([x[1] for x in rows]),
        *(np.asarray([x[j] for x in rows], np.uint32) for j in (2, 3, 4)),
        np.asarray([0, 1], np.int32), rem=rows[0][6], k=_K, rows=8,
        nsteps=1, nrows=2, interpret=True)
    want = [np.asarray(x).tolist() for x in r]
    assert search.span_segmin(rows, [0, 1], device="cpu").tolist() == want


def test_span_segmin_router_cpu_runs_plain_and_refuses_other_devices():
    sha256_cuda.reset_launches()
    rows = _group_rows("one_block")[:2]
    assert search.span_segmin(rows, [0, 1], device="cpu").dtype == \
        torch.int64
    assert sha256_cuda.total_launches() == 0
    with pytest.raises(ValueError):
        search.span_segmin(rows, [0, 1], device="meta")
    with pytest.raises(ValueError):
        sha256_cuda.sha256_segmin(rows, [0, 1], device="cpu")


# ------------------------------------------------------------ K5's table

_TABLE_MAIN = r"""
#include <cstdio>
#include <vector>
#include "table.inc"
}  // namespace
// Reads nrows nsegs n0 n1 n2 words, then the table's words; prints what
// the kernels read through SegminTable: each row's plan and partial
// slots, each segment's first row, each group's rows and block prefix.
int main() {
  int nrows, nsegs, n[3], words;
  if (scanf("%d %d %d %d %d %d", &nrows, &nsegs, &n[0], &n[1], &n[2],
            &words) != 6) {
    return 2;
  }
  std::vector<unsigned> w(words);
  for (auto& x : w) scanf("%u", &x);
  const SegminTable t(reinterpret_cast<const int*>(w.data()), nrows, nsegs,
                      n);
  for (int r = 0; r < nrows; ++r) {
    printf("row %d %d", t.pstart[r], t.pcount[r]);
    for (int j = 0; j < kPlanWords; ++j) printf(" %u", t.plans[kPlanWords * r + j]);
    printf("\n");
  }
  printf("seg");
  for (int s = 0; s <= nsegs; ++s) printf(" %d", t.seg_rows[s]);
  printf("\n");
  for (int g = 0; g < 3; ++g) {
    printf("group");
    for (int i = 0; i < n[g]; ++i) printf(" %d", t.rows[g][i]);
    printf(" |");
    for (int i = 0; i <= n[g]; ++i) printf(" %d", t.blk[g][i]);
    printf("\n");
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def table_readers(tmp_path_factory):
    """The table reader compiled with the 49-word plan (rolled body) and
    K4's 185-word one, the two ``g++`` at once: ``{body: executable}``."""
    import shutil
    import subprocess

    from tests.test_torch_hoist import _SHIM
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    d = tmp_path_factory.mktemp("segmin_table")
    src = open(sha256_cuda.SOURCE).read()
    (d / "cuda_runtime.h").write_text(_SHIM)
    (d / "table.inc").write_text(
        src[:src.index("// " + "-" * 60 + " kernels\n")])
    (d / "table.cpp").write_text(_TABLE_MAIN)
    procs = {body: subprocess.Popen(
        [cxx, "-std=c++17", "-O0", "-w", f"-I{d}",
         f"-DDBMT_BODY={sha256_cuda.BODIES[body]}", "-o", str(d / body),
         str(d / "table.cpp")]) for body in ("rolled", "hoist")}
    for proc in procs.values():
        assert proc.wait(timeout=300) == 0
    return {body: d / body for body in procs}


def _shape_rows(hoisted: bool):
    """Rows of every tail shape, interleaved: 1-block tails, 2-block ones
    whose last digit lies in the second block (R2's message), 2-block ones
    whose second block holds none; a row without a valid lane, a row
    shorter than a run; with K4's hoist when ``hoisted``."""
    rows = []
    for data, k, i0, lo_i, hi_i, n in (
            ("alpha", 5, 10_000, 10_003, 99_999, 90_000),
            ("x" * 60, 9, 100_000_000, 100_000_000, 100_299_999, 300_000),
            ("m" * 56, 5, 10_000, 10_000, 59_999, 50_000),
            ("alpha", 5, 20_000, 20_001, 20_000, 64),       # no valid lane
            ("x" * 60, 4, 1_000, 1_002, 1_007, 8),          # within a run
            ("gamma", 9, 123_000_000, 123_000_000, 123_999_999, 10 ** 6),
            ("m" * 56, 9, 100_000_000, 100_000_005, 100_000_999, 1_000),
            ("x" * 60, 9, 200_000_000, 200_000_000, 200_000_009, 10)):
        mid, tmpl, rem = _plan(data, k)
        row = (mid, tmpl, i0, lo_i, hi_i, n, rem, k)
        rows.append(row + ((sha256_torch.build_hoist(mid, tmpl, rem, k).ops,)
                           if hoisted else ()))
    return rows


@pytest.mark.parametrize("body", ["rolled", "hoist"])
def test_segmin_table_three_groups_as_the_kernels_read_it(table_readers,
                                                          body):
    """``segmin_table`` (no device) on rows of all three tail shapes: every
    row with a valid lane lands in the group of its shape
    (``variant_of``), a row without one in none; each group's blocks are
    its grid shared in proportion to the rows' runs (``_segmin_blocks``);
    and the table, read
    through the source's ``SegminTable`` (compiled as host C++), gives
    each row its ``plan_array`` plan, partial slots that are disjoint and
    inside its group's slots (group 0's first), each segment its first
    row."""
    import subprocess
    rows = _shape_rows(body == "hoist")
    seg = [0, 0, 1, 2, 3, 3, 4, 5]
    grids = (37, 50, 23)
    table = sha256_cuda.segmin_table(rows, seg, lambda v: grids[v])
    variants = [sha256_cuda.variant_of(r[6], r[7], r[1].shape[0])
                for r in rows]
    assert sorted(set(variants)) == [0, 1, 2]
    work = [sha256_cuda.runs(*r[2:6]) for r in rows]
    valid = [w > 0 for w in work]
    assert table.counts == tuple(sum(ok and v == g for v, ok in
                                     zip(variants, valid)) for g in range(3))
    shares = {}
    for g in range(3):
        members = [r for r in range(len(rows)) if variants[r] == g]
        shares.update(zip(members, sha256_cuda._segmin_blocks(
            [work[r] for r in members], grids[g], sha256_cuda.THREADS)))
    assert table.grids == tuple(sum(shares[r] for r in range(len(rows))
                                    if variants[r] == g) for g in range(3))
    words = table.words.tolist()
    stdin = (f"{table.nrows} {table.nsegs} {' '.join(map(str, table.counts))}"
             f" {len(words)}\n" + " ".join(map(str, words)) + "\n")
    out = subprocess.run([str(table_readers[body])], input=stdin,
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.split("\n")
    slots = set()
    for r, (row, line) in enumerate(zip(rows, out)):
        _, start, count, *plan = line.split()
        start, count = int(start), int(count)
        assert list(map(int, plan)) == sha256_cuda.plan_array(
            *row[:8], hoist=row[8] if len(row) > 8 else None).tolist()
        assert count == shares[r] and (count > 0) == valid[r]
        mine = set(range(start, start + count))
        assert not mine & slots
        slots |= mine
        base = sum(table.grids[:variants[r]])
        assert mine <= set(range(base, base + table.grids[variants[r]]))
    assert slots == set(range(sum(table.grids)))
    assert out[len(rows)] == "seg 0 2 3 4 6 7 8"
    pstart = [int(ln.split()[1]) for ln in out[:len(rows)]]
    for g in range(3):
        members, blk = out[len(rows) + 1 + g].split("|")
        members = list(map(int, members.split()[1:]))
        blk = list(map(int, blk.split()))
        assert members == [r for r in range(len(rows))
                           if variants[r] == g and valid[r]]
        assert blk[0] == 0 and blk[-1] == table.grids[g]
        base = sum(table.grids[:g])
        assert [base + b for b in blk[:-1]] == [pstart[r] for r in members]


def test_segmin_table_refuses_rows_it_cannot_search():
    """Mixed hoists, a tail whose block count does not match its shape,
    lanes past 2^32 and descending segments raise before anything is
    copied or launched."""
    rows = _shape_rows(False)
    hoisted = _shape_rows(True)
    grid = (lambda v: 8)
    with pytest.raises(ValueError):
        sha256_cuda.segmin_table([hoisted[0], rows[1]], [0, 1], grid)
    mid, tmpl, rem = _plan("alpha", 5)
    with pytest.raises(ValueError):   # a 1-block template at rem 61
        sha256_cuda.segmin_table([(mid, tmpl, 0, 0, 99, 100, 61, 5)], [0],
                                 grid)
    with pytest.raises(ValueError):
        sha256_cuda.segmin_table([(mid, tmpl, M32, M32, M32, 2, rem, 5)],
                                 [0], grid)
    with pytest.raises(ValueError):
        sha256_cuda.segmin_table(rows[:2], [1, 0], grid)


# ------------------------------------------------------- batched dispatch

def test_dispatch_batch_equals_search_and_oracle():
    """Mixed messages (1- and 2-block tails), multi-class and multi-block
    ranges, a single nonce, a job repeated: every answer equals the job's
    own ``search`` and the hashlib scan; one batched launch per 64 rows."""
    s = {d: NonceSearcher(d, device="cpu") for d in
         ("alpha", "bee", "a" * 40, "m" * 56)}
    entries = [(s["alpha"], 100_000, 101_000), (s["bee"], 100_050, 100_949),
               (s["a" * 40], 99_000, 102_000), (s["m" * 56], 5, 2_500),
               (s["alpha"], 100_123, 100_123), (s["bee"], 100_050, 100_949)]
    s0 = entries[0][0]
    before = s0.device_launches
    got = s0.finalize_batch(s0.dispatch_batch(entries))
    assert s0.device_launches - before == 1
    for (searcher, lo, up), pair in zip(entries, got):
        assert pair == searcher.search(lo, up) == \
            scan_min(searcher.data, lo, up)


def test_dispatch_batch_splits_at_the_row_cap(monkeypatch):
    monkeypatch.setattr(miner_model, "BATCH_ROWS_MAX", 3)
    a = NonceSearcher("split", device="cpu")
    entries = [(a, 0, 999), (a, 5_000, 20_000)]       # 4 + 2 rows
    before = a.device_launches
    handle = a.dispatch_batch(entries)
    assert a.device_launches - before == 2
    assert a.finalize_batch(handle) == [scan_min("split", 0, 999),
                                        scan_min("split", 5_000, 20_000)]


def test_dispatch_batch_none_when_searchers_cannot_share():
    a = NonceSearcher("one", device="cpu")
    assert a.dispatch_batch([(a, 0, 99), (NonceSearcher(
        "two", device="cpu", grid=37), 0, 99)]) is None
    assert a.dispatch_batch([(a, 0, 99), (object(), 0, 99)]) is None


def test_dispatch_batch_empty_range_raises():
    a = NonceSearcher("inverted", device="cpu")
    with pytest.raises(ValueError):
        a.dispatch_batch([(a, 0, 99), (a, 100, 99)])


@pytest.mark.gpu
def test_segmin_kernel_equals_plain_on_card():
    """K5 against its plain version on the card, at the default grid and
    at an odd one, and the batched dispatch against per-job search."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run chip_smoke.py on the GPU)")
    dev = torch.device("cuda", 0)
    rows, seg = [], []
    for name in _GROUPS:
        base = seg[-1] + 1 if seg else 0
        rows += _group_rows(name)
        seg += [base + s for s in _SEGS[name]]
    want = search.span_segmin_scan(rows, seg, device=dev).cpu().tolist()
    for grid in (None, 37):
        got = sha256_cuda.sha256_segmin(rows, seg, device=dev, grid=grid)
        assert (got.cpu().to(torch.int64) & M32).tolist() == want
    a, b = NonceSearcher("alpha", device=dev), NonceSearcher("m" * 56,
                                                             device=dev)
    entries = [(a, 0, 10 ** 6), (b, 99_000, 102_000)]
    assert a.finalize_batch(a.dispatch_batch(entries)) == \
        [s.search(lo, hi) for s, lo, hi in entries]


# ------------------------------------------------------- the miner alone

class _ScriptClient:
    """Fake AsyncClient: serves scripted Requests, records writes, then
    parks until cancelled."""

    def __init__(self, payloads):
        self._payloads = list(payloads)
        self.writes = []
        self.closed = False
        self._forever = asyncio.get_running_loop().create_future()

    async def read(self):
        if self._payloads:
            return self._payloads.pop(0)
        await self._forever

    def write(self, payload):
        self.writes.append(payload)

    async def close(self):
        self.closed = True


def _drive(payloads, expect: int, **kw):
    """Run a port MinerWorker over scripted Requests until ``expect``
    Results land (or it closes); returns (replies, worker)."""
    async def scenario():
        worker = MinerWorker("unused:0", **kw)
        worker.client = _ScriptClient(payloads)
        task = asyncio.create_task(worker.run())
        for _ in range(1_000):
            if len(worker.client.writes) >= expect or worker.client.closed \
                    or task.done():
                break
            await asyncio.sleep(0.01)
        task.cancel()
        return [Message.from_json(w) for w in worker.client.writes], worker
    return asyncio.run(scenario())


_RANGES = [(100_000 + i * 500, 100_000 + i * 500 + 399) for i in range(6)]


def test_coalescer_batches_queued_chunks_in_order():
    payloads = [new_request("coal order", lo, up).to_json()
                for lo, up in _RANGES]
    replies, worker = _drive(payloads, 6, searcher_factory=cpu_factory())
    assert [(m.hash, m.nonce) for m in replies] == \
        [scan_min("coal order", lo, up) for lo, up in _RANGES]
    assert worker.coalesced_dispatches >= 1
    assert worker.coalesced_chunks >= 2


def test_coalesce_off_reproduces_the_serial_path(monkeypatch):
    # Untraced: a traced Result carries its chunk's timings, which no two
    # runs share; the stock bytes must match.
    monkeypatch.setenv("DBMT_TRACE", "0")
    payloads = [new_request("coal parity", lo, up).to_json()
                for lo, up in _RANGES]
    off, w_off = _drive(list(payloads), 6, searcher_factory=cpu_factory(),
                        coalesce=False)
    serial, _ = _drive(list(payloads), 6, searcher_factory=cpu_factory(),
                       pipeline=False)
    assert w_off.coalesced_dispatches == 0
    assert [m.to_json() for m in off] == [m.to_json() for m in serial]
    assert [(m.hash, m.nonce) for m in off] == \
        [scan_min("coal parity", lo, up) for lo, up in _RANGES]


def test_difficulty_and_oversize_chunks_never_coalesce():
    target = 1 << 60
    spans = [(100_000, 100_399, 0), (100_400, 100_799, target),
             (100_800, 101_199, 0), (101_200, 101_599, 0),
             (101_600, 102_599, 0)]       # the last is above the 450 cap
    replies, worker = _drive(
        [new_request("coal mix", lo, up, t).to_json()
         for lo, up, t in spans], 5, searcher_factory=cpu_factory(),
        coalesce_max=450)
    for (lo, up, t), m in zip(spans, replies):
        want = (scan_until("coal mix", lo, up, t)[:2] if t
                else scan_min("coal mix", lo, up))
        assert (m.hash, m.nonce, m.target) == (*want, t)
    assert worker.coalesced_chunks <= 2


def test_failing_batched_launch_ends_the_miner(monkeypatch):
    """No fallback: when the batched launch raises, the miner closes its
    connection and answers none of the drained chunks, neither through
    the per-job chain nor the plain tier."""
    def broken(*args, **kw):
        raise RuntimeError("dbmt_sha256_segmin launch failed")
    monkeypatch.setattr(miner_model, "span_segmin", broken)
    calls = []
    factory = cpu_factory()

    def spying(data):
        s = factory(data)
        for name in ("search", "dispatch"):
            fn = getattr(s, name)
            setattr(s, name, lambda *a, _fn=fn, _n=name: (
                calls.append(_n), _fn(*a))[1])
        return s
    payloads = [new_request("broken batch", lo, up).to_json()
                for lo, up in _RANGES[:4]]

    async def scenario():
        worker = MinerWorker("unused:0", searcher_factory=spying)
        worker.client = _ScriptClient(payloads)
        # All four Requests are queued before the loop starts, so the
        # first turn drains them into one batch.
        await asyncio.wait_for(worker.run(), 30)
        return worker
    worker = asyncio.run(scenario())
    assert worker.client.closed and worker.client.writes == []
    assert calls == []


# --------------------------------------------- end to end over real LSP

def _pin_rate(sched, rate):
    """Freeze the pool throughput estimate (CPU miners answer in
    milliseconds; a real sample would make every chunk plan tiny)."""
    if isinstance(sched, RefScheduler):
        sched._pool_rate = rate
        sched._observe_result = lambda miner, chunk: None
    else:
        sched.miner_plane.pool_rate = rate
        sched.miner_plane.observe_result = lambda miner, chunk: None


async def _tenant(hostport, params, mice):
    client = await new_async_client(hostport, params)
    for data, lo, up, target in mice:
        client.write(new_request(data, lo, up, target).to_json())
    out = []
    try:
        while len(out) < len(mice):
            msg = Message.from_json(await asyncio.wait_for(client.read(),
                                                           60))
            if msg.type == MsgType.RESULT:
                out.append((msg.hash, msg.nonce))
    finally:
        await client.close()
    return out


@pytest.mark.parametrize("coalesce", [True, False], ids=["coalesce",
                                                        "per_chunk"])
@pytest.mark.parametrize("ref", [False, True], ids=["port", "jax"])
def test_mice_share_launches_end_to_end(ref, coalesce):
    """An elephant chunked over two port miners while three tenants send
    mice (one of them a difficulty request): with coalescing on, the
    scheduler stacks the mice into coalescing windows and the miners
    serve them in batched launches; with it off, neither happens. Every
    answer equals the hashlib scan over the range the system scans, in
    each tenant's request order."""
    params = fast_params()
    elephant = ("elephant", 0, 160_000, 0)
    mice = [[(f"mouse {t}", 0, 300 + 97 * j, 1 << 62 if (t, j) == (0, 1)
              else 0) for j in range(3)] for t in range(3)]

    async def scenario():
        qos = None if ref else QosParams(wholesale_s=0.1, chunk_s=0.05,
                                         lazy=False)
        async with Cluster(params, ref_scheduler=ref, qos=qos) as c:
            if ref:
                c.scheduler.lease = LeaseParams(enabled=False)
                c.scheduler.qos = RefQosParams(wholesale_s=0.1, chunk_s=0.05,
                                               lazy=False)
                c.scheduler.coalesce = RefCoalesceParams(enabled=coalesce)
                c.scheduler.adapt_plane = None
            else:
                c.scheduler.miner_plane.coalesce = CoalesceParams(
                    enabled=coalesce)
                c.scheduler.adapt_plane = None
            workers = [await c.start_miner(worker=MinerWorker(
                c.hostport, params=params, coalesce=coalesce,
                searcher_factory=cpu_factory(delay=0.02)))
                for _ in range(2)]
            _pin_rate(c.scheduler, 50_000.0)
            el = asyncio.create_task(_tenant(c.hostport, params,
                                             [elephant]))
            await asyncio.sleep(0.2)
            got = await asyncio.gather(*(_tenant(c.hostport, params, m)
                                         for m in mice))
            return (await el, got, workers,
                    c.scheduler.stats["qos_window_grants"])
    (el,), got, workers, window_grants = asyncio.run(scenario())
    assert el == scan_min("elephant", 0, elephant[2] + 1)
    for tenant, answers in zip(mice, got):
        assert answers == [scan_until(d, lo, up + 1, t)[:2] if t
                           else scan_min(d, lo, up + 1)
                           for d, lo, up, t in tenant]
    dispatches = sum(w.coalesced_dispatches for w in workers)
    assert (dispatches >= 1 and window_grants >= 1) if coalesce \
        else (dispatches == 0 and window_grants == 0)
