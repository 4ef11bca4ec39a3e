"""The port's peeled search (K3, K4) and its host hoist plan against the JAX
package and the hashlib oracle, bit for bit.

Every check is exact (uint32 words, tolerance 0). Inputs are fixed messages
and seeded numpy draws at small sizes. The JAX side runs on the CPU: its
``hoist_structure``/``build_hoist`` and ``compress_tail_hoisted`` (jnp),
its Pallas kernel in interpret mode with ``peel=True`` (K3 without a hoist,
K4 with one) as ``tests/test_pallas.py`` runs it, and its ``NonceSearcher``
on the jnp tier. The port runs its plain versions on the CPU. The CUDA
lane bodies are also compiled as host C++ (when a C++ compiler is there)
and held against the hashlib oracle; K3 and K4 themselves run only on a
card (``gpu`` marker; ``chip_smoke.py`` holds them against the plain
versions there).
"""

import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from distributed_bitcoinminer_tpu.bitcoin.hash import (hash_op, scan_min,
                                                       scan_until)
from distributed_bitcoinminer_tpu.models.miner_model import \
    NonceSearcher as RefSearcher
from distributed_bitcoinminer_tpu.ops import sha256_jnp as ref_jnp
from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
from distributed_bitcoinminer_tpu_torch.ops import (search, sha256_cuda,
                                                    sha256_torch)
from distributed_bitcoinminer_tpu_torch.ops.sha256_host import \
    sha256_midstate
from distributed_bitcoinminer_tpu_torch.utils import config
from tests.test_torch_ops import GRID, message_for

M32 = 0xFFFFFFFF
#: Tail shapes: 1-block (rem 8, 31), 2-block with digits in both blocks
#: (61 at k 9; 60 and 63 spill one or two words), a digit-free second
#: block (52 at k 9), and the spill edge 60-63 at small k.
HOIST_CASES = [(0, 1), (8, 9), (31, 5), (52, 9), (55, 9), (60, 9), (61, 9),
               (62, 5), (63, 9), (63, 1)]


def _tail(rem: int, k: int, seed: int = 0):
    """(data, midstate, template) of a seeded message with ``rem`` tail
    bytes before the k digits."""
    data = message_for(rem, seed=seed + rem * 16 + k)
    prefix = data.encode() + b" "
    mid, tail = sha256_midstate(prefix)
    assert len(tail) == rem
    return data, mid, sha256_torch.build_tail_template(tail, k,
                                                       len(prefix) + k)


def _words(t) -> list:
    return [int(x) & M32 for x in (t.tolist() if hasattr(t, "tolist")
                                   else t)]


def test_hoist_structure_equals_reference():
    """Every rem 0-63, k 1-9 and block count a tail can have, in the
    32-round window and the 48-round one."""
    for rem in range(64):
        for k in range(1, 10):
            nb = 1 if rem + k + 9 <= 64 else 2
            for rounds in (32, 48):
                assert sha256_torch.hoist_structure(rem, k, nb, rounds) == \
                    ref_jnp.hoist_structure(rem, k, nb, rounds)
            full = [f for _, _, f in sha256_torch.hoist_structure(rem, k,
                                                                  nb)]
            assert not any(full[:-1])   # only the last block is digit-free


@pytest.mark.parametrize("deep_window", [False, True])
@pytest.mark.parametrize("rem,k", HOIST_CASES)
def test_build_hoist_equals_reference(rem, k, deep_window):
    _, mid, tmpl = _tail(rem, k)
    got = sha256_torch.build_hoist(mid, tmpl, rem, k, deep_window)
    want = ref_jnp.build_hoist(mid, tmpl, rem, k, deep_window=deep_window)
    assert got.ops.keys() == want.ops.keys()
    for name, arr in got.ops.items():
        assert arr.dtype == np.uint32 and np.array_equal(arr,
                                                         want.ops[name])
    assert (got.wd0, got.nblocks, got.full_const) == (
        want.wd0, want.nblocks, want.full_const)
    assert ("ckw" in got.ops) == (tmpl.shape[0] == 2
                                  and (rem + k - 1) // 4 < 16)


def test_build_hoist_takes_no_device_probe(monkeypatch):
    """The deep window is an explicit argument, off by default; no
    environment knob or device decides it."""
    monkeypatch.setenv("DBM_HOIST_DEEP", "1")
    _, mid, tmpl = _tail(8, 9)
    assert "cw2" not in sha256_torch.build_hoist(mid, tmpl, 8, 9).ops


@pytest.mark.parametrize("rem,k", [(8, 9), (52, 9), (61, 9), (63, 1),
                                   (0, 5)])
def test_hoisted_lanes_equal_jnp_compress_tail_hoisted(rem, k):
    import jax.numpy as jnp
    _, mid, tmpl = _tail(rem, k, seed=100)
    rng = np.random.default_rng(rem * 16 + k)
    lanes = rng.integers(10 ** (k - 1) if k > 1 else 0, 10 ** k, size=16)
    ops = sha256_torch.build_hoist(mid, tmpl, rem, k).ops
    i = torch.as_tensor(lanes, dtype=torch.int64)
    hi, lo = sha256_torch.hash_lanes(mid, tmpl, i, rem, k, hoist=ops)
    ji = jnp.asarray(lanes.astype(np.uint32))
    contrib = ref_jnp.digit_contrib(ji, rem, k)
    st = ref_jnp.compress_tail_hoisted(
        np.asarray(mid, np.uint32), tmpl, contrib, ops, rem=rem, k=k,
        shape=ji.shape)
    assert hi.tolist() == np.asarray(st[0]).astype(np.int64).tolist()
    assert lo.tolist() == np.asarray(st[1]).astype(np.int64).tolist()


@pytest.mark.parametrize("rem,k", GRID)
def test_hoisted_lanes_equal_hash_op(rem, k):
    """The plain hoisted compression (K4's plain version) against the
    hashlib oracle over the rem x k grid, in both static windows."""
    data, mid, tmpl = _tail(rem, k, seed=200)
    rng = np.random.default_rng(rem * 16 + k)
    lanes = rng.integers(10 ** (k - 1) if k > 1 else 0, 10 ** k, size=32)
    i = torch.as_tensor(lanes, dtype=torch.int64)
    want = [hash_op(data, int(n)) for n in lanes]
    for deep in (False, True):
        ops = sha256_torch.build_hoist(mid, tmpl, rem, k, deep).ops
        hi, lo = sha256_torch.hash_lanes(mid, tmpl, i, rem, k, hoist=ops)
        assert [h << 32 | l for h, l in zip(hi.tolist(), lo.tolist())] == \
            want


@pytest.mark.parametrize("case", ["k3_1block", "k4_spill"])
def test_peeled_pallas_interpret_equals_plain(case):
    """The JAX package's peeled Pallas kernel in interpret mode (rows=1,
    nsteps=1): K3 (no hoist) and K4 (the hoist's operands) against the
    port's plain scans on the same window."""
    from distributed_bitcoinminer_tpu.ops.sha256_pallas import \
        pallas_search_span
    rem, k = {"k3_1block": (8, 5), "k4_spill": (61, 9)}[case]
    data, mid, tmpl = _tail(rem, k, seed=300)
    i0 = 20_000 if k == 5 else 123_000_000
    lo_i, hi_i = i0 + 7, i0 + 120
    hoist = (None if case.startswith("k3")
             else sha256_torch.build_hoist(mid, tmpl, rem, k).ops)
    want = _words(pallas_search_span(
        np.asarray(mid, np.uint32), tmpl, np.uint32(i0), np.uint32(lo_i),
        np.uint32(hi_i), hoist, rem=rem, k=k, rows=1, nsteps=1,
        interpret=True, peel=True))
    got = _words(search.span_argmin(mid, tmpl, i0, lo_i, hi_i, 128, rem=rem,
                                    k=k, device="cpu", peel=True,
                                    hoist=hoist))
    assert got == want
    o_hash, o_nonce = scan_min(data, lo_i, hi_i)
    assert (got[0] << 32 | got[1], got[2]) == (o_hash, o_nonce)


def test_routers_pass_the_hoist_only_with_peel(monkeypatch):
    """Every router hands the kernel wrapper ``hoist if peel else None``
    and its ``peel``, as the Pallas wrappers do."""
    calls = []

    def recorder(name):
        def record(*args, **kw):
            calls.append((name, kw["peel"], kw.get("hoist")))
            return "launched"
        return record
    for name in ("sha256_argmin", "sha256_until", "sha256_argmin_fold",
                 "sha256_until_fold"):
        monkeypatch.setattr(sha256_cuda, name, recorder(name))
    _, mid, tmpl = _tail(8, 5)
    ops = sha256_torch.build_hoist(mid, tmpl, 8, 5).ops
    cuda = torch.device("cuda")
    for peel in (False, True):
        search.span_argmin(mid, tmpl, 0, 0, 9, 10, rem=8, k=5, device=cuda,
                           peel=peel, hoist=ops)
        search.span_until(mid, tmpl, 0, 0, 9, 10, 1, 2, rem=8, k=5,
                          device=cuda, peel=peel, hoist=ops)
        search.devloop_span(mid, tmpl, None, 0, 0, 9, 10, 0, rem=8, k=5,
                            device=cuda, peel=peel, hoist=ops)
        search.devloop_span_until(mid, tmpl, None, 0, 0, 9, 10, 1, 2, 0,
                                  rem=8, k=5, device=cuda, peel=peel,
                                  hoist=ops)
    assert [(n, p) for n, p, _ in calls] == [
        (n, p) for p in (False, True)
        for n in ("sha256_argmin", "sha256_until", "sha256_argmin_fold",
                  "sha256_until_fold")]
    assert all((h is ops) == p for _, p, h in calls)
    assert sha256_cuda.total_launches() == 0


def test_kernel_plan_words_carry_the_hoist_in_tpu_order():
    """K4's plan: the 49 words, then deep (8), kw and cw (16 a block,
    padded to two blocks), ckw (64, or zeros); a deep window's cw2 does
    not travel; a hoist of another shape is refused."""
    for rem, k in ((8, 9), (52, 9), (61, 9)):
        _, mid, tmpl = _tail(rem, k)
        nb = tmpl.shape[0]
        base = sha256_cuda.plan_array(mid, tmpl, 5, 6, 7, 8, rem,
                                      k).tolist()
        for deep in (False, True):
            ops = sha256_torch.build_hoist(mid, tmpl, rem, k, deep).ops
            words = sha256_cuda.plan_array(mid, tmpl, 5, 6, 7, 8, rem, k,
                                           hoist=ops).tolist()
            assert len(words) == sha256_cuda.HOIST_PLAN_WORDS == 185
            assert words[:49] == base
            pad = [0] * (16 * (2 - nb))
            assert words[49:57] == [int(x) for x in ops["deep"]]
            assert words[57:89] == [int(x) for x in ops["kw"].ravel()] + pad
            assert words[89:121] == [int(x) for x in ops["cw"].ravel()] + pad
            assert words[121:] == ([int(x) for x in ops["ckw"]]
                                   if "ckw" in ops else [0] * 64)
        # A hoist of another shape: another block count or ckw.
        o_rem = {8: 52, 52: 61, 61: 8}[rem]
        _, o_mid, o_tmpl = _tail(o_rem, 9)
        other = sha256_torch.build_hoist(o_mid, o_tmpl, o_rem, 9).ops
        with pytest.raises(ValueError):
            sha256_cuda.plan_array(mid, tmpl, 5, 6, 7, 8, rem, k,
                                   hoist=other)


def test_kernel_wrappers_refuse_a_hoist_without_peel_and_mixed_rows():
    _, mid, tmpl = _tail(8, 5)
    ops = sha256_torch.build_hoist(mid, tmpl, 8, 5).ops
    assert sha256_cuda.body_of(False, None) == "rolled"
    assert sha256_cuda.body_of(True, None) == "peel"
    assert sha256_cuda.body_of(True, ops) == "hoist"
    with pytest.raises(ValueError):
        sha256_cuda.body_of(False, ops)
    row = (mid, tmpl, 0, 0, 99, 100, 8, 5)
    with pytest.raises(ValueError):
        sha256_cuda.sha256_segmin([row + (ops,), row], [0, 1],
                                  device=torch.device("cuda"), peel=True)
    with pytest.raises(ValueError):
        sha256_cuda.sha256_argmin(mid, tmpl, 0, 0, 99, 100, rem=8, k=5,
                                  device="cpu", peel=True, hoist=ops)
    assert [sha256_cuda.variant_of(rem, k, nb)
            for rem, k, nb in ((8, 9, 1), (52, 9, 2), (61, 9, 2), (55, 1, 2),
                               (56, 9, 2))] == [0, 2, 1, 2, 1]
    assert sha256_cuda.total_launches() == 0


def test_segmin_scan_with_hoisted_rows_equals_plain():
    rows = []
    for rem, k in ((8, 5), (52, 9), (61, 9)):
        _, mid, tmpl = _tail(rem, k, seed=400)
        i0 = 0 if k == 5 else 123_000_000
        rows.append((mid, tmpl, i0, i0 + 3, i0 + 150, 160, rem, k,
                     sha256_torch.build_hoist(mid, tmpl, rem, k).ops))
    seg = [0, 1, 1]
    want = search.span_segmin_scan([r[:8] for r in rows], seg, device="cpu")
    assert search.span_segmin_scan(rows, seg, device="cpu").tolist() == \
        want.tolist()
    for peel in (False, True):
        assert search.span_segmin(rows, seg, device="cpu",
                                  peel=peel).tolist() == want.tolist()


#: Searcher ranges: a digit-class boundary on a 1-block tail, 2-block
#: tails with digits in both blocks, a digit-free second block.
SEARCH_CASES = (("cmu440", 9_990, 10_150), ("x" * 60, 100, 300),
                ("a fifty-character message; its digits stay in one.",
                 123_456_780, 123_456_900))


@functools.lru_cache(maxsize=None)
def _reference_answers():
    """The JAX jnp tier with its hoist on the 1-block range of one digit
    class: ``search``, and ``search_until`` at a target its arg-min
    meets (each 2-block shape would cost seconds more of compiling)."""
    ref = RefSearcher("cmu440", batch=256, tier="jnp", hoist=True)
    best = ref.search(10_000, 10_150)
    return best, ref.search_until(10_000, 10_150, best[0] + 1)


@pytest.mark.parametrize("hoist", [True, False])
def test_peeled_searcher_equals_reference_and_oracle(hoist):
    """``search``, ``search_until`` and ``dispatch_batch`` of a peeled CPU
    searcher (the plain versions of K4, or K3 without the hoist) against
    the JAX jnp tier with its hoist and the hashlib oracle."""
    cases = SEARCH_CASES
    searchers = [NonceSearcher(d, device="cpu", peel=True, hoist=hoist)
                 for d, _, _ in cases]
    for s, (data, lo, hi) in zip(searchers, cases):
        plans = list(s.plan(lo, hi))
        assert all((p.hoist is not None) == hoist for p in plans)
        want = scan_min(data, lo, hi)
        assert s.search(lo, hi) == want
        t = want[0] + 1
        assert s.search_until(lo, hi, t) == scan_until(data, lo, hi, t)
        miss = s.search_until(lo, hi, want[0])
        assert miss == (*want, False)
    ref, ref_until = _reference_answers()
    assert searchers[0].search(10_000, 10_150) == ref
    assert searchers[0].search_until(10_000, 10_150, ref[0] + 1) == \
        ref_until
    entries = [(s, lo, hi) for s, (_, lo, hi) in zip(searchers, cases)]
    got = searchers[0].finalize_batch(searchers[0].dispatch_batch(entries))
    assert got == [scan_min(d, lo, hi) for d, lo, hi in cases]


def test_hoist_is_built_once_per_midstate_and_only_for_k4():
    from distributed_bitcoinminer_tpu_torch.utils.metrics import registry
    on = registry().counter("model.hoist_plans", enabled="true")
    off = registry().counter("model.hoist_plans", enabled="false")
    n_on, n_off = on.value, off.value
    s = NonceSearcher("cmu440", device="cpu", peel=True)
    a = list(s.plan(10 ** 9, 3 * 10 ** 9 - 1))
    b = list(s.plan(10 ** 9, 2 * 10 ** 9 - 1))
    assert len(a) == 2 and a[0].hoist is b[0].hoist is not None
    assert on.value - n_on == 2 and off.value == n_off
    for peel, use_hoist in ((False, True), (True, False)):
        s = NonceSearcher("cmu440", device="cpu", peel=peel, hoist=use_hoist)
        assert next(iter(s.plan(0, 9))).hoist is None
    assert off.value - n_off == 2 and on.value - n_on == 2


def test_coalesce_key_separates_lane_bodies():
    bodies = [(False, True), (True, True), (True, False)]
    searchers = [NonceSearcher("cmu440", device="cpu", peel=p, hoist=h)
                 for p, h in bodies]
    keys = {s.coalesce_key() for s in searchers}
    assert len(keys) == 3
    assert NonceSearcher("x", device="cpu", peel=True).coalesce_key() == \
        searchers[1].coalesce_key()
    s0 = searchers[1]
    assert s0.dispatch_batch([(s0, 0, 9), (searchers[2], 0, 9)]) is None
    assert s0.dispatch_batch([(s0, 0, 9), (searchers[0], 0, 9)]) is None


def test_peel_knobs_and_their_defaults(monkeypatch):
    from distributed_bitcoinminer_tpu_torch.apps import miner
    monkeypatch.delenv("DBMT_PEEL", raising=False)
    monkeypatch.delenv("DBMT_HOIST", raising=False)
    assert config.peel_from_env() == config.PeelParams(False, True)
    monkeypatch.setenv("DBMT_PEEL", "1")
    assert config.peel_from_env() == config.PeelParams(True, True)
    monkeypatch.setenv("DBMT_HOIST", "0")
    body = config.peel_from_env()
    assert body == config.PeelParams(True, False)
    s = miner.default_searcher_factory("x", "cpu", body)
    assert (s.peel, s.use_hoist) == (True, False)
    monkeypatch.setenv("DBMT_PEEL", "yes")   # malformed: the default
    assert not config.peel_from_env().peel


def test_build_all_starts_one_nvcc_per_stale_body_at_once(monkeypatch,
                                                          tmp_path):
    """Every stale body's nvcc starts before any is waited for, each with
    its ``-DDBMT_BODY``; an up-to-date library is not rebuilt and keeps
    its build's facts."""
    libs = {b: str(tmp_path / f"lib_{b}.so") for b in sha256_cuda.BODIES}
    monkeypatch.setattr(sha256_cuda, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(sha256_cuda, "LIBRARIES", libs)
    monkeypatch.setattr(sha256_cuda, "build_info", {})
    monkeypatch.setattr(sha256_cuda, "_nvcc", lambda: "nvcc")
    events = []

    class FakeNvcc:
        def __init__(self, cmd, **_kw):
            events.append(("start", cmd))
            self.out, self.returncode = cmd[cmd.index("-o") + 1], 0

        def communicate(self):
            events.append(("wait", self.out))
            open(self.out, "w").close()
            return "", "ptxas info    : Used 64 registers"
    monkeypatch.setattr(sha256_cuda.subprocess, "Popen", FakeNvcc)
    assert sha256_cuda.build_all() == libs
    assert [e[0] for e in events] == ["start"] * 3 + ["wait"] * 3
    assert [f"-DDBMT_BODY={n}" in cmd for (_, cmd), n in zip(events, (0, 1, 2))
            ] == [True] * 3
    assert sha256_cuda.build("hoist") == libs["hoist"] and len(events) == 6
    assert sha256_cuda.build_info["hoist"]["built"]
    assert "64 registers" in sha256_cuda.build_info["hoist"]["ptxas"]


_SHIM = r"""
#pragma once
#include <cstdint>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __constant__ static const
#define __launch_bounds__(x)
#define __shared__ static
struct ShimDim { unsigned x, y, z; };
static ShimDim threadIdx, blockIdx, blockDim, gridDim;
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, unsigned n) {
  n &= 31u;
  return n ? (lo >> n) | (hi << (32u - n)) : lo;
}
inline uint32_t __shfl_down_sync(unsigned, uint32_t v, int) { return v; }
inline uint32_t __shfl_sync(unsigned, uint32_t v, int) { return v; }
inline unsigned __activemask() { return 1u; }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline uint32_t atomicAdd(uint32_t* a, uint32_t v) {
  const uint32_t old = *a;
  *a += v;
  return old;
}
inline void __syncthreads() {}
"""

_MAIN = r"""
#include <cstdio>
#include "bodies.inc"
}  // namespace
int main() {
  int n, nw;
  if (scanf("%d %d", &n, &nw) != 2 || nw != kPlanWords) return 2;
  for (int c = 0; c < n; ++c) {
    uint32_t w[kPlanWords];
    unsigned i;
    for (int j = 0; j < nw; ++j) scanf("%u", &w[j]);
    scanf("%u", &i);
    Plan p;
    memcpy(&p, w, sizeof(Plan));
    Key key{0u, 0u, 0u};
    // Lane i as a run of one lane.
    const uint32_t d = i % kRun;
    auto one = [&](const Key& k) {
      key = k;
      return true;
    };
    switch (plan_variant(p)) {
      case 0: LaneBody<0>(p).run(p, i - d, d, d, one); break;
      case 1: LaneBody<1>(p).run(p, i - d, d, d, one); break;
      case 2: LaneBody<2>(p).run(p, i - d, d, d, one); break;
    }
    printf("%u %u\n", key.hi, key.lo);
  }
  return 0;
}
"""


@pytest.mark.parametrize("body", ["peel", "hoist"])
def test_cuda_lane_bodies_as_host_cpp_equal_hash_op(body, tmp_path):
    """K3's and K4's lane bodies from ``csrc/sha256_argmin.cu`` (the code
    before its kernels, and ``plan_variant``), compiled as host C++ with a
    shim for the CUDA intrinsics, against the hashlib oracle at every
    rem 0-63 and k 1-9: the shapes the kernels' switches enumerate."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    src = open(sha256_cuda.SOURCE).read()
    head = src[:src.index("// " + "-" * 60 + " kernels\n")]
    start = src.index("int plan_variant(const Plan& p) {")
    variant = src[start:src.index("\n}\n", start) + 3]
    (tmp_path / "cuda_runtime.h").write_text(_SHIM)
    (tmp_path / "bodies.inc").write_text(head + "static " + variant)
    (tmp_path / "lanes.cpp").write_text(_MAIN)
    exe = tmp_path / "lanes"
    subprocess.run([cxx, "-std=c++17", "-O1", "-w", f"-I{tmp_path}",
                    f"-DDBMT_BODY={sha256_cuda.BODIES[body]}", "-o",
                    str(exe), str(tmp_path / "lanes.cpp")], check=True,
                   timeout=300)
    rng = np.random.default_rng(44)
    lines, want = [], []
    for rem in range(64):
        for k in range(1, 10):
            prefix = bytes(rng.integers(32, 127, size=64 + rem,
                                        dtype=np.uint8))
            mid, tail = sha256_midstate(prefix)
            tmpl = sha256_torch.build_tail_template(tail, k,
                                                    len(prefix) + k)
            hoist = (sha256_torch.build_hoist(mid, tmpl, rem, k).ops
                     if body == "hoist" else None)
            words = sha256_cuda.plan_array(mid, tmpl, 0, 0, 0, 0, rem, k,
                                           hoist=hoist).tolist()
            for i in {0, 10 ** k - 1, int(rng.integers(0, 10 ** k))}:
                lines.append(" ".join(map(str, words + [i])))
                d = hashlib.sha256(prefix + f"{i:0{k}d}".encode()).digest()
                want.append(f"{int.from_bytes(d[:4], 'big')} "
                            f"{int.from_bytes(d[4:8], 'big')}")
    stdin = f"{len(lines)} {len(words)}\n" + "\n".join(lines) + "\n"
    out = subprocess.run([str(exe)], input=stdin, capture_output=True,
                         text=True, check=True, timeout=120,
                         env=dict(os.environ))
    assert out.stdout.split("\n")[:-1] == want


@pytest.mark.gpu
def test_peeled_kernels_equal_plain_on_card():
    """K3 and K4 against their plain versions on the card: the arg-min
    launch and the until launch, 1- and 2-block tails, a digit-free
    second block, valid edges off the thread and block edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run chip_smoke.py on the GPU)")
    dev = torch.device("cuda", 0)
    for rem, k in ((8, 9), (52, 9), (61, 9), (63, 2)):
        _, mid, tmpl = _tail(rem, k)
        ops = sha256_torch.build_hoist(mid, tmpl, rem, k).ops
        i0, n = (0, 100) if k == 2 else (5_000_000, (1 << 18) + 5)
        lo_i, hi_i = i0 + 3, i0 + n - 7
        want = _words(search.span_scan(mid, tmpl, i0, lo_i, hi_i, n,
                                       rem=rem, k=k, device=dev))
        t = (want[0] << 32 | want[1]) + 1
        want_u = _words(search.span_until_scan(
            mid, tmpl, i0, lo_i, hi_i, n, t >> 32, t & M32, rem=rem, k=k,
            device=dev))
        for hoist in (None, ops):
            assert _words(sha256_cuda.sha256_argmin(
                mid, tmpl, i0, lo_i, hi_i, n, rem=rem, k=k, device=dev,
                peel=True, hoist=hoist)) == want
            assert _words(sha256_cuda.sha256_until(
                mid, tmpl, i0, lo_i, hi_i, n, t >> 32, t & M32, rem=rem,
                k=k, device=dev, peel=True, hoist=hoist))[:2] == want_u[:2]
