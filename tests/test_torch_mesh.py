"""The port's mesh plane (K6's mesh bodies) and the ALU probe (K7) against
the JAX package and the hashlib oracle, bit for bit.

Every check is exact (uint32 words, tolerance 0). Inputs are fixed ranges
and seeded numpy draws at small sizes. The JAX side runs on the CPU: its
``device_windows``, and its ``MeshNonceSearcher`` on the jnp tier over the
conftest's virtual CPU devices, three calls in all (each new signature
costs it seconds), cached at module scope. Everything else is held to the
hashlib oracle (``bitcoin.hash``) and to the port's single-device
``NonceSearcher``. The port runs its plain versions on a CPU mesh
(``devices=["cpu"] * n``). The mesh folds and K7's lane are also compiled
as host C++ (when a compiler is there); the kernels themselves run only on
a card (``gpu`` marker; ``chip_smoke.py`` holds them against the plain
versions there).
"""

import functools
import os
import shutil
import subprocess
from unittest import mock

import numpy as np
import pytest
import torch

from distributed_bitcoinminer_tpu.bitcoin.hash import scan_min, scan_until
from distributed_bitcoinminer_tpu.models import \
    MeshNonceSearcher as RefMeshSearcher
from distributed_bitcoinminer_tpu.parallel import make_mesh as ref_make_mesh
from distributed_bitcoinminer_tpu.parallel.partition import \
    device_windows as ref_device_windows
from distributed_bitcoinminer_tpu_torch.apps.miner import \
    default_searcher_factory
from distributed_bitcoinminer_tpu_torch.models import (MeshNonceSearcher,
                                                       NonceSearcher)
from distributed_bitcoinminer_tpu_torch.ops import (alu_probe, search,
                                                    searchop, sha256_cuda)
from distributed_bitcoinminer_tpu_torch.parallel import mesh_search
from distributed_bitcoinminer_tpu_torch.parallel.partition import \
    device_windows
from distributed_bitcoinminer_tpu_torch.utils.config import (PeelParams,
                                                             mesh_from_env)
from tests.test_torch_hoist import _SHIM

M32 = 0xFFFFFFFF
#: The range the JAX mesh runs: one 10^4 block, 3,001 lanes.
REF_RANGE = (1000, 4000)
#: About one nonce in 500 qualifies: the first hit lies inside REF_RANGE.
REF_TARGET = (1 << 64) // 500
#: Ranges for the port alone: several blocks over three digit classes, a
#: window narrower than 3 or 4 shards, nonces past 2^32 (one block of 10^9
#: whose window starts at lane 294,967,246).
SPANS = {"classes": (95, 1020), "narrow": (7, 8),
         "past_2p32": ((1 << 32) - 50, (1 << 32) + 50)}


@functools.lru_cache(maxsize=None)
def _ref_mesh(n: int, until: bool):
    """The JAX package's mesh searcher over REF_RANGE on n virtual CPU
    devices (jnp tier); until mode runs its devloop until body."""
    ref = RefMeshSearcher("cmu440", batch=256, mesh=ref_make_mesh(n),
                          tier="jnp", hoist=False)
    if not until:
        return ref.search(*REF_RANGE)
    with mock.patch.dict(os.environ, {"DBM_DEVLOOP_UNTIL": "1"}):
        return ref.search_until(*REF_RANGE, REF_TARGET)


def _cpu_mesh(n: int, **kw) -> MeshNonceSearcher:
    return MeshNonceSearcher("cmu440", devices=["cpu"] * n, **kw)


def test_device_windows_equal_reference():
    """Seeded windows at n 1-8 and three batch widths, empty trailing
    windows included."""
    rng = np.random.default_rng(50)
    for _ in range(60):
        lo = int(rng.integers(0, 10 ** 9))
        hi = lo + int(rng.choice([0, 1, 2, 5, 7, int(rng.integers(8, 10**6))]))
        for n in range(1, 9):
            for batch in (1, 64, 1000):
                got = device_windows(lo, hi, n, batch)
                want = ref_device_windows(lo, hi, n, batch)
                for g, w in zip(got[:3], want[:3]):
                    assert g.dtype == np.uint32
                    np.testing.assert_array_equal(g, w)
                assert got[3] == want[3]
    for fn in (device_windows, ref_device_windows):
        with pytest.raises(ValueError, match="empty window"):
            fn(5, 4, 2, 1)


@pytest.mark.parametrize("n", [3, 4])
def test_mesh_search_equals_jax_mesh(n):
    """n = 4 cuts 3,001 lanes into even windows, n = 3 into uneven ones."""
    want = _ref_mesh(n, False)
    assert want == scan_min("cmu440", *REF_RANGE)
    assert _cpu_mesh(n).search(*REF_RANGE) == want
    assert NonceSearcher("cmu440", device="cpu").search(*REF_RANGE) == want


def test_mesh_search_until_equals_jax_mesh_devloop_until():
    want = _ref_mesh(4, True)
    assert want == scan_until("cmu440", *REF_RANGE, REF_TARGET)
    assert want[2]
    assert _cpu_mesh(4).search_until(*REF_RANGE, REF_TARGET) == want


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("span", sorted(SPANS))
def test_mesh_search_equals_oracle_and_single_device(span, n):
    lower, upper = SPANS[span]
    sha256_cuda.reset_launches()
    mesh = _cpu_mesh(n)
    got = mesh.search(lower, upper)
    assert got == scan_min("cmu440", lower, upper)
    assert got == NonceSearcher("cmu440", device="cpu").search(lower, upper)
    assert mesh.device_launches == len(list(mesh.plan(lower, upper)))
    assert sha256_cuda.total_launches() == 0   # the CPU mesh ran no kernel


def _scanned(lo: int, hi: int, lowest: int) -> int:
    """Lanes the plain until scan of a shard's window ``[lo, hi]`` hashes
    given the block's lowest hit so far (it scans none above it)."""
    return max(0, min(hi, lowest) - lo + 1)


def _counting_until_scans(scans: list):
    """A stand-in for the mesh's plain until scan that records each
    shard's ``(lo, hi, lowest)`` and then scans."""
    until_scan = search.span_until_scan

    def counting(*args, **kw):
        scans.append((args[3], args[4], kw.get("lowest", M32)))
        return until_scan(*args, **kw)
    return mock.patch.object(mesh_search, "span_until_scan", counting)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("case", ["hit", "miss", "hit_first_block"])
def test_mesh_search_until_equals_oracle_and_single_device(case, n):
    """A hit inside a multi-block span, a target nothing meets, and a hit
    in the first of several blocks (every later shard search must then do
    no lane work). Within a block the shards pass the lowest hit on (the
    plain version of the word they share on a card): every shard after
    the one holding a block's first hit scans no lane."""
    lower, upper = SPANS["classes"]
    best = scan_min("cmu440", lower, upper)[0]
    target = {"hit": (1 << 64) // 50, "miss": best,
              "hit_first_block": 1 << 63}[case]
    want = scan_until("cmu440", lower, upper, target)
    scans = []
    with _counting_until_scans(scans):
        got = _cpu_mesh(n).search_until(lower, upper, target)
    assert got == want
    assert got == NonceSearcher("cmu440", device="cpu").search_until(
        lower, upper, target)
    assert want[2] == (case != "miss")
    after_hit = [s for s in scans if s[2] != M32]
    assert all(lowest < lo and _scanned(lo, hi, lowest) == 0
               for lo, hi, lowest in after_hit)
    if case == "miss":
        assert not after_hit
    if case == "hit_first_block":
        assert want[1] < 100
        assert all(lo < 100 for lo, _, _ in scans)   # block 0 only
        # Shard 0 holds the block's first hit: the others scan nothing
        # (block 0's 5 lanes fill at most 3 shard windows).
        assert len(after_hit) == len(scans) - 1 == min(n, 3) - 1


def _only_shard_2_hits() -> tuple:
    """A one-block span of "cmu440" whose four shard windows have their
    lowest hash in shard 2 (below every lane of shards 0 and 1), and the
    target that only that lane of shards 0-2 meets: (lower, upper,
    target, the lane's nonce)."""
    for lower in range(1000, 9000, 400):
        upper = lower + 399
        _, lo_d, hi_d, _ = device_windows(lower, upper, 4, 1)
        mins = [scan_min("cmu440", int(a), int(b))
                for a, b in zip(lo_d, hi_d)]
        if mins[2][0] < min(mins[0][0], mins[1][0]):
            return lower, upper, mins[2][0] + 1, mins[2][1]
    raise AssertionError("no span puts its lowest hash in shard 2")


def test_mesh_until_only_shard_2_hits():
    """Only shard 2 of four holds a lane below the target: shards 0 and 1
    scan their whole windows, shard 2 finds the hit, shard 3 (above it)
    scans nothing; the answer is the oracle's and the single-device
    searcher's."""
    lower, upper, target, nonce = _only_shard_2_hits()
    want = scan_until("cmu440", lower, upper, target)
    assert want[1:] == (nonce, True)
    scans = []
    with _counting_until_scans(scans):
        got = _cpu_mesh(4).search_until(lower, upper, target)
    assert got == want == NonceSearcher(
        "cmu440", device="cpu").search_until(lower, upper, target)
    lanes = [_scanned(lo, hi, lowest) for lo, hi, lowest in scans]
    assert lanes[:2] == [100, 100] and 0 < lanes[2] <= 100
    assert lanes[3] == 0 and scans[3][2] == nonce < scans[3][0]


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_hash_tie_goes_to_the_earliest_nonce(n, monkeypatch):
    """Lane hashes with ties across shards and blocks: (idx mod 7, 0). The
    minimum hash 0 recurs in every shard's window (in one block, and over
    several); the earliest nonce wins, as in the single-device chain."""
    def tied(midstate, template, i, rem, k, hoist=None):
        return i % 7, torch.zeros_like(i)
    monkeypatch.setattr(search, "hash_lanes", tied)
    one = NonceSearcher("cmu440", device="cpu")
    for (lower, upper), first in (((95, 1020), 98), ((100, 999), 105)):
        want = min(((lane % 7) << 32, p.base + lane)
                   for p in one.plan(lower, upper)
                   for lane in range(p.lo_i, p.hi_i + 1))
        assert want == (0, first)
        assert _cpu_mesh(n).search(lower, upper) == want
        assert one.search(lower, upper) == want


@pytest.mark.parametrize("hoist", [False, True])
def test_peeled_plain_tier_on_the_mesh(hoist):
    """``peel=True`` (K3's plain version, and with the hoist K4's) over a
    3-shard mesh equals the oracle, arg-min and until."""
    mesh = _cpu_mesh(3, peel=True, hoist=hoist)
    for lower, upper in (SPANS["classes"], SPANS["past_2p32"]):
        assert mesh.search(lower, upper) == scan_min("cmu440", lower, upper)
        assert mesh.search_until(lower, upper, (1 << 64) // 50) == \
            scan_until("cmu440", lower, upper, (1 << 64) // 50)


def _seeded_rows(rng, n: int, until: bool) -> np.ndarray:
    """n shard rows with hash ties, index ties, and all-ones rows (an
    empty shard, or a found-0 until row)."""
    rows = np.empty((n, 5), dtype=np.int64)
    rows[:, 2] = rng.choice([0, 1, M32], size=n)
    rows[:, 3] = rng.choice([5, 6, M32], size=n)
    rows[:, 4] = rng.choice([3, 9, 2 ** 31, M32 - 1], size=n)
    rows[:, 1] = np.where(rng.random(n) < 0.4,
                          rng.integers(0, 10 ** 6, size=n), M32)
    rows[:, 0] = rows[:, 1] != M32
    empty = rng.random(n) < 0.25
    rows[empty] = [0, M32, M32, M32, M32]
    return rows if until else rows[:, 2:]


def test_mesh_lex_min_equals_numpy():
    rng = np.random.default_rng(51)
    for _ in range(200):
        n = int(rng.integers(1, 9))
        until = bool(rng.integers(0, 2))
        rows = _seeded_rows(rng, n, until)
        got = mesh_search.mesh_lex_min(torch.from_numpy(rows), until=until)
        keys = [tuple(r[-3:]) for r in rows.tolist()]
        want = list(min(keys))
        if until:
            f = int(rows[:, 1].min())
            want = [int(f != M32), f] + want
        assert got.tolist() == want
        # int32 bit patterns (the kernels' words) merge the same.
        as_i32 = torch.from_numpy(rows.astype(np.uint32).view(np.int32))
        assert mesh_search.mesh_lex_min(as_i32, until=until).tolist() == want


_FOLD_MAIN = r"""
#include <cstdio>
#include "folds.inc"
}  // namespace
int main() {
  int cases;
  if (scanf("%d", &cases) != 1) return 2;
  for (int c = 0; c < cases; ++c) {
    int until, n;
    unsigned base_hi, base_lo, carry[8], rows[5 * 16];
    scanf("%d %d %u %u", &until, &n, &base_hi, &base_lo);
    const int words = until ? 8 : 5, width = until ? 5 : 3;
    for (int w = 0; w < words; ++w) scanf("%u", &carry[w]);
    for (int w = 0; w < n * width; ++w) scanf("%u", &rows[w]);
    if (until) {
      mesh_fold_until_words(carry, rows, n, base_hi, base_lo);
    } else {
      mesh_fold_argmin_words(carry, rows, n, base_hi, base_lo);
    }
    for (int w = 0; w < words; ++w) printf("%u ", carry[w]);
    printf("\n");
  }
  return 0;
}
"""


def _host_exe(tmp_path, name: str, source: str, main: str, marker: str):
    """``source`` up to its kernels ``marker``, with the CUDA shim, plus
    ``main``, compiled as host C++ (skips without a compiler)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    src = open(source).read()
    (tmp_path / "cuda_runtime.h").write_text(_SHIM)
    (tmp_path / f"{name}.inc").write_text(src[:src.index(marker)])
    (tmp_path / f"{name}.cpp").write_text(main)
    exe = tmp_path / name
    subprocess.run([cxx, "-std=c++17", "-O1", "-w", f"-I{tmp_path}", "-o",
                    str(exe), str(tmp_path / f"{name}.cpp")], check=True,
                   timeout=300)
    return exe


def test_mesh_fold_words_as_host_cpp_equal_plain(tmp_path):
    """The mesh fold kernels' code (``mesh_fold_argmin_words``,
    ``mesh_fold_until_words`` in ``csrc/sha256_argmin.cu``) against their
    plain versions: seeded rows with ties and all-ones rows, found and
    not-found carries, and block bases whose low word wraps."""
    exe = _host_exe(tmp_path, "folds", sha256_cuda.SOURCE, _FOLD_MAIN,
                    "// " + "-" * 60 + " kernels\n")
    rng = np.random.default_rng(52)
    lines, want = [], []
    for c in range(400):
        until = c % 2 == 1
        n = int(rng.integers(1, 9))
        rows = _seeded_rows(rng, n, until)
        op = searchop.UNTIL_OP if until else searchop.ARGMIN_OP
        carry = op.init()
        if c % 4 >= 2:   # a carry that has seen (and, until, found) some
            carry = torch.from_numpy(rng.choice(
                [0, 1, 5, M32 - 1], size=op.carry_words).astype(np.int64))
            carry[-1] = 1
            if until:
                carry[0] = int(rng.integers(0, 2))
        base = (int(rng.integers(0, 3)) << 32) | int(
            rng.choice([0, 999, M32 - 4, M32]))
        fold = (mesh_search.fold_rows_until if until
                else mesh_search.fold_rows_argmin)
        want.append(" ".join(map(str, fold(carry, torch.from_numpy(rows),
                                           base).tolist())) + " ")
        lines.append(" ".join(map(str, [int(until), n, base >> 32,
                                        base & M32, *carry.tolist(),
                                        *rows.reshape(-1).tolist()])))
    out = subprocess.run([str(exe)], input=f"{len(lines)}\n"
                         + "\n".join(lines) + "\n", capture_output=True,
                         text=True, check=True, timeout=60)
    assert out.stdout.split("\n")[:-1] == want


def test_plain_until_fold_leaves_a_found_carry():
    carry = torch.tensor([1, 0, 7, 0, 0, 0, 0, 1])
    rows = torch.tensor([[1, 3, 0, 0, 3], [0, M32, M32, M32, M32]])
    assert mesh_search.fold_rows_until(carry, rows, 0).tolist() == \
        carry.tolist()


def _numpy_vpu_tile(iters: int) -> np.ndarray:
    """``scripts/tpu_tune.py::vpu_kernel`` (:51-66) transcribed to numpy:
    one (8, 128) uint32 tile."""
    xs = [np.broadcast_to(np.arange(128, dtype=np.uint32), (8, 128))
          + np.uint32(i) for i in range(8)]
    for i in range(iters):
        out = []
        for x in xs:
            r = (x >> np.uint32(7)) | (x << np.uint32(25))
            out.append((r ^ x) + (np.uint32(i) + x))
        xs = out
    acc = xs[0]
    for x in xs[1:]:
        acc = acc ^ x
    return acc


@pytest.mark.parametrize("iters", [0, 1, 13])
def test_alu_probe_plain_equals_tpu_script(iters):
    got = alu_probe.alu_probe_plain(3 * 1024, iters).numpy()
    tile = _numpy_vpu_tile(iters).astype(np.int64)
    for at in range(0, 3 * 1024, 1024):   # every 1,024 lanes, one tile
        np.testing.assert_array_equal(got[at:at + 1024].reshape(8, 128),
                                      tile)


def test_alu_probe_lane_as_host_cpp_equals_plain(tmp_path):
    main = r"""
#include <cstdio>
#include "probe.inc"
}  // namespace
int main() {
  for (unsigned col = 0; col < 128; ++col) printf("%u\n", probe_lane(col, 13));
  return 0;
}
"""
    exe = _host_exe(tmp_path, "probe", alu_probe.SOURCE, main,
                    "// " + "-" * 60 + " kernels\n")
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         check=True, timeout=60)
    assert [int(x) for x in out.stdout.split()] == \
        alu_probe.alu_probe_plain(128, 13).tolist()


def test_miner_factory_picks_the_mesh_from_env(monkeypatch):
    monkeypatch.setenv("DBMT_MESH_DEVICES", "cpu, cpu,cpu")
    mesh = mesh_from_env("cuda")
    assert mesh == ("cpu", "cpu", "cpu")
    s = default_searcher_factory("cmu440", "cpu", PeelParams(peel=True),
                                 mesh)
    assert isinstance(s, MeshNonceSearcher) and s.n_devices == 3
    assert s.devices == (torch.device("cpu"),) * 3 and s.peel
    assert s.search(*SPANS["narrow"]) == scan_min("cmu440", *SPANS["narrow"])
    monkeypatch.setenv("DBMT_MESH_DEVICES", "cpu")
    one = default_searcher_factory("cmu440", "cpu", PeelParams(),
                                   mesh_from_env("cpu"))
    assert type(one) is NonceSearcher
    monkeypatch.delenv("DBMT_MESH_DEVICES")
    assert mesh_from_env("cpu") == ()
    assert mesh_from_env("cuda") == tuple(
        f"cuda:{i}" for i in range(torch.cuda.device_count()))


def test_mesh_batch_rides_the_single_device_segment_min():
    """Coalesced mice on a mesh searcher: the inherited batched dispatch
    on the mesh's first device, each answer its own search's; a mesh
    searcher never shares a launch with a single-device one."""
    a, b = _cpu_mesh(3), MeshNonceSearcher("mouse", devices=["cpu"] * 3)
    entries = [(a, 0, 999), (b, 95, 1020), (a, 7, 8)]
    assert a.finalize_batch(a.dispatch_batch(entries)) == \
        [scan_min(s.data, lo, hi) for s, lo, hi in entries]
    assert a.dispatch_batch([(NonceSearcher("cmu440", device="cpu"),
                              0, 9)]) is None
    assert _cpu_mesh(2).coalesce_key() != a.coalesce_key()


def test_mesh_refuses_mixed_and_missing_devices(monkeypatch):
    with pytest.raises(ValueError, match="no mesh search"):
        mesh_search.mesh_devloop_span(
            None, None, (), 0, 9, 0, rem=0, k=1,
            devices=(torch.device("cpu"), torch.device("meta")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MeshNonceSearcher("cmu440", devices=["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_search.make_mesh()


def test_mesh_kernel_wrappers_refuse_cpu():
    rows = torch.zeros((2, 5), dtype=torch.int32)
    carry = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        sha256_cuda.mesh_fold_until(rows, carry, 0, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        sha256_cuda.mesh_fold_argmin(rows[:, :3], carry[:5], 0, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        sha256_cuda.sha256_argmin(None, None, 0, 0, 0, 1, rem=0, k=1,
                                  device="cpu", out=rows[0, :3])
    with pytest.raises(ValueError, match="CUDA device"):
        sha256_cuda.sha256_until_shard(None, None, carry, 0, 0, 0, 1, 0, 0,
                                       rem=0, k=1, device="cpu",
                                       hit=carry[:2])
    with pytest.raises(ValueError, match="CUDA device"):
        sha256_cuda.k6_fold(rows.reshape(-1)[:6], carry[:5], 0,
                            device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        sha256_cuda.enable_peer_access("cpu", "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        alu_probe.alu_probe(1, device="cpu")
    assert sha256_cuda._libs == {} and alu_probe._lib == []


def test_tune_int32_split_and_cli_without_card(monkeypatch, capsys):
    """The tuning tool's INT32-pipe count of K7's SASS loop as the H100
    build emits it (IMAD and VIADD go to the FMA pipe, the branch to
    control flow), and its CLI exiting 1 with nothing on stdout where
    torch finds no card."""
    from distributed_bitcoinminer_tpu_torch.tools import tune
    loop = (["SHF.R.W.U32.HI R5, R4, 0x7, R4"] * 8 + ["LOP3.LUT R6"] * 8
            + ["IMAD.IADD R7, R6, 0x1, R5"] * 13 + ["IADD3 R8"] * 3
            + ["VIADD R2, R2, 0x1", "ISETP.NE.AND P0, PT, R2, R9, PT",
               "@P0 BRA `(.L_x_1)"])
    ops = tune.opcode_counts(loop)
    assert ops == {"SHF": 8, "LOP3": 8, "IMAD": 13, "IADD3": 3, "VIADD": 1,
                   "ISETP": 1, "BRA": 1}
    assert tune.int32_count(ops) == 20
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tune.main(["24", "K1=1498", "K4=1277"]) == 1
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("width", [3, 5])
def test_cross_card_block_copies_rows_and_folds_on_every_holder(width):
    """The CUDA mesh's per-block bookkeeping for several cards, with stub
    search and fold and two distinct CPU device keys in the place of two
    cards: shards 0 and 2 on one, 1 and 3 on the other, the last shard's
    window empty. Each shard searches on its own device with that
    device's carry, into its row there (the first shard on each device
    told so); each holder then has every shard's row (the other device's
    copied in, the empty shard's the sentinel) and folds once, with its
    own carry."""
    a, b = torch.device("cpu"), torch.device("cpu", 0)
    devices = (a, b, a, b)
    carries = (torch.zeros(width + 3, dtype=torch.int32),
               torch.ones(width + 3, dtype=torch.int32))
    windows = [(0, 10, 19), (1, 20, 29), (2, 30, 39)]
    searched, folded = [], []

    def search(d, row, carry, lo, hi, first):
        searched.append((d, carry, lo, hi, first))
        row.copy_(torch.arange(width, dtype=torch.int32) + lo)

    def fold(rows, carry, d):
        folded.append((d, carry, rows.clone()))

    out = mesh_search._cuda_block(devices, carries, windows, width, search,
                                  fold)
    assert out is carries
    assert [(d, lo, hi) for d, _, lo, hi, _ in searched] == \
        [(devices[s], lo, hi) for s, lo, hi in windows]
    assert all(c is carries[d != a] for d, c, *_ in searched)
    assert [e[4] for e in searched] == [True, True, False]
    empty = [0] + [-1] * 4 if width == 5 else [-1] * 3
    want = torch.tensor([[lo + j for j in range(width)]
                         for _, lo, _ in windows] + [empty],
                        dtype=torch.int32)
    assert [d for d, _, _ in folded] == [a, b]
    for (_, carry, got), mine in zip(folded, carries):
        assert carry is mine and torch.equal(got, want)


@pytest.mark.parametrize("scope", ["mesh", "card"])
def test_mesh_span_shares_hit_words_by_scope(scope, monkeypatch):
    """A span's words over two (stub) cards, shards 0 and 2 on one, 1 and
    3 on the other: one (2,) all-ones word pair a card. In "mesh" scope
    each card's peers are the other card's lowest-hit word and peer
    access is enabled for each ordered pair, with the searcher's body; in
    "card" scope a card has no peers and nothing is enabled. One card
    never has peers."""
    enabled = []
    monkeypatch.setattr(sha256_cuda, "enable_peer_access",
                        lambda a, b, body: enabled.append((a, b, body)))
    a, b = torch.device("cpu"), torch.device("cpu", 0)
    span = mesh_search.MeshSpan((a, b, a, b), scope, "hoist")
    assert set(span.words) == {a, b}
    assert all(torch.equal(w, torch.full((2,), -1, dtype=torch.int32))
               for w in span.words.values())
    if scope == "mesh":
        assert enabled == [(a, b, "hoist"), (b, a, "hoist")]
        for t, u in ((a, b), (b, a)):
            assert [w.data_ptr() for w in span.hit_peers[t]] == \
                [span.words[u].data_ptr()]
            assert span.hit_peers[t][0].shape == (1,)
    else:
        assert span.hit_peers == {a: [], b: []} and not enabled
    assert mesh_search.MeshSpan((a,) * 4, scope).hit_peers == {a: []}
    assert len(enabled) == (2 if scope == "mesh" else 0)


def _stub_mesh_kernels(monkeypatch, log: list):
    """The mesh plane's kernel wrappers replaced by stubs that log each
    call (and write a row as the shards' reduces would) and a mesh type
    check that takes CPU device keys for cards."""
    monkeypatch.setattr(mesh_search, "_mesh_type", lambda devices: "cuda")

    def shard(kind):
        def stub(*args, device, out, **kw):
            log.append((kind, device, out, kw))
            out.fill_(1)
        return stub

    def mesh_fold(kind):
        def stub(rows, carry, base, *, device, body):
            log.append((kind, device, rows, carry, base))
        return stub
    for name, kind in (("sha256_argmin", "argmin"),
                       ("sha256_until_shard", "until"),
                       ("mesh_fold_argmin", "fold"),
                       ("mesh_fold_until", "fold")):
        monkeypatch.setattr(sha256_cuda, name, (
            mesh_fold if kind == "fold" else shard)(kind))


def _two_blocks(until: bool, devices, carries, span):
    """Blocks [0, 99] and [100, 199] of one plan through the mesh
    router."""
    mid, tmpl = [0] * 8, torch.zeros((1, 16), dtype=torch.int64)
    for lo, hi in ((0, 99), (100, 199)):
        if until:
            mesh_search.mesh_devloop_span_until(
                mid, tmpl, carries, lo, hi, 0, 0, 1000, rem=0, k=3,
                devices=devices, span=span)
        else:
            mesh_search.mesh_devloop_span(mid, tmpl, carries, lo, hi, 1000,
                                          rem=0, k=3, devices=devices)


def test_cross_card_until_resets_each_word_once_a_block_after_the_folds(
        monkeypatch):
    """The until chain over two stub cards (shards 0 and 2 on one, 1 and
    3 on the other) for two blocks: each shard gets its card's hit words
    and the other card's lowest-hit word as its peer; each card's lowest
    hit is reset once a block, by its first shard there, and in block 2
    only after every card folded block 1 (each fold waits for every
    shard's row of its block, copied in on both cards' streams, so no
    late hit of block 1 lands in block 2's word)."""
    monkeypatch.setattr(sha256_cuda, "enable_peer_access",
                        lambda a, b, body: None)
    a, b = torch.device("cpu"), torch.device("cpu", 0)
    devices = (a, b, a, b)
    span = mesh_search.MeshSpan(devices, "mesh")
    carries = (torch.zeros(8, dtype=torch.int32),
               torch.zeros(8, dtype=torch.int32))
    log = []
    _stub_mesh_kernels(monkeypatch, log)
    _two_blocks(True, devices, carries, span)
    kinds = [e[0] for e in log]
    assert kinds == (["until"] * 4 + ["fold"] * 2) * 2
    for e in log:
        if e[0] == "until":
            d, kw = e[1], e[3]
            other = b if d == a else a
            assert kw["hit"] is span.words[d]
            assert [w.data_ptr() for w in kw["peers"]] == \
                [span.words[other].data_ptr()]
    for block in (log[:6], log[6:]):
        resets = [e[1] for e in block if e[0] == "until" and e[3]["first"]]
        assert resets == [a, b]   # shards 0 and 1, the first on each card
        assert [e[1] for e in block if e[0] == "fold"] == [a, b]
        # every holder folds all four rows, the other card's copied in
        for e in block:
            if e[0] == "fold":
                assert torch.equal(e[2], torch.ones((4, 5),
                                                    dtype=torch.int32))
    first_reset = next(j for j, e in enumerate(log[6:], 6)
                       if e[0] == "until" and e[3]["first"])
    assert first_reset == 6 and all(e[0] == "fold" for e in log[4:6])


def test_hit_scope_needs_peer_access_between_every_pair(monkeypatch):
    """``hit_scope``: "mesh" on one card and on a CPU mesh (the searcher's
    read-only attribute); across (stub) cards "mesh" only when every
    ordered pair can reach the other's memory, else "card"; "card" past
    the peers a shard can write. Asking enables no peer access (the
    span does, :class:`MeshSpan`)."""
    mesh = _cpu_mesh(3)
    assert mesh.hit_scope == "mesh"
    with pytest.raises(AttributeError):
        mesh.hit_scope = "card"
    monkeypatch.setattr(mesh_search, "_mesh_type", lambda devices: "cuda")
    enabled = []
    monkeypatch.setattr(sha256_cuda, "enable_peer_access",
                        lambda a, b, body: enabled.append((a, b, body)))
    a, b = torch.device("cpu"), torch.device("cpu", 0)
    assert mesh_search.hit_scope((a, a, a)) == "mesh"
    denied = {(b, a)}
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda x, y: (x, y) not in denied)
    assert mesh_search.hit_scope((a, b, a, b)) == "card"
    denied.clear()
    assert mesh_search.hit_scope((a, b, a, b)) == "mesh"
    many = tuple(torch.device("cpu", i) for i in range(
        sha256_cuda.MAX_PEERS + 2))
    assert mesh_search.hit_scope(many) == "card"
    assert not enabled


@pytest.mark.parametrize("until", [False, True])
def test_one_card_mesh_folds_once_a_block(until, monkeypatch):
    """Four shards on one (stub) card for two blocks: each block's four
    shard searches write the four rows of one rows tensor, then one mesh
    fold merges them into the card's carry (no row is copied); the until
    shards share the card's hit words, reset by each block's first
    shard, with no peers."""
    d = torch.device("cpu")
    devices = (d,) * 4
    carry = torch.zeros(8 if until else 5, dtype=torch.int32)
    span = mesh_search.MeshSpan(devices, mesh_search.hit_scope(devices))
    assert span.hit_peers == {d: []}
    log = []
    _stub_mesh_kernels(monkeypatch, log)
    _two_blocks(until, devices, (carry,), span if until else None)
    shard = "until" if until else "argmin"
    assert [e[0] for e in log] == ([shard] * 4 + ["fold"]) * 2
    for block in (log[:5], log[5:]):
        _, dev, rows, folded, base = block[4]
        assert dev == d and folded is carry and base == 1000
        assert rows.shape == (4, 5 if until else 3)
        assert [e[2].data_ptr() for e in block[:4]] == \
            [r.data_ptr() for r in rows]
        for j, (_, dev, _, kw) in enumerate(block[:4]):
            assert dev == d
            if until:
                assert kw["first"] == (j == 0) and kw["peers"] == []
                assert kw["hit"] is span.words[d]


@pytest.mark.gpu
def test_mesh_kernels_equal_plain_on_card():
    """The mesh searcher over four shards of card 0 against the
    single-device chain, and K7 against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run chip_smoke.py on the GPU)")
    mesh = MeshNonceSearcher("cmu440", devices=["cuda:0"] * 4)
    one = NonceSearcher("cmu440", device="cuda:0")
    for lower, upper in SPANS.values():
        assert mesh.search(lower, upper) == one.search(lower, upper)
        assert mesh.search_until(lower, upper, 1 << 63) == \
            one.search_until(lower, upper, 1 << 63)
    k7 = alu_probe.alu_probe(2, 13, device="cuda:0")
    assert ((k7.to(torch.int64) & M32).cpu()
            == alu_probe.alu_probe_plain(k7.numel(), 13)).all()
