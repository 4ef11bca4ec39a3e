"""The search kernels' lane code, compiled as host C++, bit for bit.

``csrc/sha256_argmin.cu`` before its kernels (the pipe helpers, the round
code, the lane bodies, the walk over runs of lanes and K2's walk in grabs)
is compiled with ``g++`` through the CUDA shim of
``tests/test_torch_hoist.py``, once for each lane body (the rolled one,
K1's; the peeled one, K3's; the hoist-fed peeled one, K4's), and driven
by a small harness:

- the pipe helpers (``fadd``, ``fmad``, ``fshr``) and ``rotr`` against
  Python's integer arithmetic on seeded words at every shift amount;
- each body, a run of lanes at a time, in every variant (a 1-block tail,
  the last digit in the second block, a digit-free second block) against
  the hashlib oracle at every ``rem`` 0-63 and ``k`` 1-9, on the runs at
  both ends of the digit class and a seeded one;
- the walk over runs with a simulated ``gridDim x blockDim`` against the
  port's plain ``span_scan`` and the JAX package's ``search_span`` (jnp,
  on the CPU), on seeded windows with unaligned edges, runs cut at both
  ends and windows shorter than a run, at two grid sizes;
- the walk with a stub body whose hashes collide on purpose, so that the
  earliest nonce must win every tie;
- K2's walk (``UntilWalk``): simulated warps of 32 lanes take grabs of
  32 x G runs (G 1 and 4) from one shared counter, each taking its next
  grab before it works the current one and reading the lowest hit one run
  ahead, in several warp orders, against the plain until scan and the
  JAX package's ``search_span_until``: seeded windows (shorter than a run
  among them), the first hit in the last run of a grab, and a last grab
  that crosses the window's end; and as a mesh until shard's walk, with
  the lowest hit already stored by an earlier shard: no run taken and no
  lane hashed above it, the first qualifier still found below it.

Every check is exact. The kernels themselves run only on a card
(``chip_smoke.py``).
"""

import functools
import hashlib
import shutil
import subprocess

import numpy as np
import pytest

from distributed_bitcoinminer_tpu.ops.search import (search_span,
                                                      search_span_until)
from distributed_bitcoinminer_tpu_torch.ops import search, sha256_cuda
from distributed_bitcoinminer_tpu_torch.ops import sha256_torch
from distributed_bitcoinminer_tpu_torch.ops.sha256_host import \
    sha256_midstate
from tests.test_torch_hoist import _SHIM

M32 = 0xFFFFFFFF
#: The shift amounts the pipe helpers are held at: every one.
SHIFTS = range(1, 32)

_MAIN = r"""
#include <cstdio>
#include <memory>
#include <vector>
#include "lanes.inc"
}  // namespace

template <int N>
static void shifts(uint32_t x) {
  if constexpr (N < 32) {
    printf(" %u", fshr<N>(x));
    shifts<N + 1>(x);
  }
}

static Plan read_plan() {
  uint32_t w[kPlanWords];
  for (int j = 0; j < kPlanWords; ++j) scanf("%u", &w[j]);
  Plan p;
  memcpy(&p, w, sizeof(Plan));
  return p;
}

// Every lane key of the runs base + [dlo, dhi] under the plan's variant.
template <int V>
static void print_run(const Plan& p, uint32_t base, uint32_t dlo,
                      uint32_t dhi) {
  LaneBody<V>(p).run(p, base, dlo, dhi, [&](const Key& k) {
    printf("%u %u %u\n", k.hi, k.lo, k.idx);
    return false;
  });
}

// K1's search over the plan's valid lanes with `threads` simulated
// threads: each walks its runs, then the minimum over the threads.
template <int V>
static Key walk(const Plan& p, uint32_t threads) {
  const LaneBody<V> body(p);
  uint32_t first, last;
  valid_lanes(p, first, last);
  Key best = sentinel();
  for (uint32_t t = 0; t < threads; ++t) {
    Key mine = sentinel();
    walk_runs(first, last, t, threads,
              [&](uint32_t base, uint32_t dlo, uint32_t dhi) {
                body.run(p, base, dlo, dhi, [&](const Key& c) {
                  if (key_less(c, mine)) mine = c;
                  return false;
                });
                return true;
              });
    if (key_less(mine, best)) best = mine;
  }
  return best;
}

// K2's warp in the CPU tests (see UntilWalk): all 32 lanes in one object,
// the counter and the lowest hit shared by every warp.
struct HostWarp {
  uint32_t* counter;   // runs handed out
  uint32_t* f_min;     // the lowest hit
  uint32_t lane(int l) const { return static_cast<uint32_t>(l); }
  uint32_t take(uint32_t runs) const {
    const uint32_t c = *counter;
    *counter += runs;
    return c;
  }
  uint32_t broadcast(uint32_t v) const { return v; }
  bool vote(bool any) const { return any; }
  uint32_t lowest() const { return *f_min; }
  void hit(uint32_t i) const { *f_min = i < *f_min ? i : *f_min; }
};

// A lane body that counts the lanes it hashes and keeps the highest.
template <int V>
struct CountingBody {
  LaneBody<V> body;
  uint32_t* hashed;
  uint32_t* top;
  template <class Visit>
  void run(const Plan& p, uint32_t base, uint32_t dlo, uint32_t dhi,
           Visit&& visit) const {
    body.run(p, base, dlo, dhi, [&](const Key& k) {
      *top = *hashed == 0u || k.idx > *top ? k.idx : *top;
      ++*hashed;
      return visit(k);
    });
  }
};

// K2's search: simulated warps of 32 lanes walk grabs of 32 x G runs from
// one shared counter against one shared lowest hit, a grab a turn in the
// order given (a warp's first turn takes its first grab, as a warp that
// starts late does); a warp stops when its step says so. SHARED: as a
// mesh until shard, whose lowest hit starts at `preset` (all-ones: none;
// else a hit an earlier shard stored) and whose warps start no walk when
// it lies below the window (starts_above_hit), printing the lanes hashed,
// the highest of them and the runs handed out too.
template <uint32_t G, int V, bool SHARED>
static void until(const Plan& p, const std::vector<uint32_t>& order,
                  uint32_t preset) {
  uint32_t hashed = 0u, top = 0u;
  const CountingBody<V> body{LaneBody<V>(p), &hashed, &top};
  uint32_t first, last, counter = 0u, f_min = preset;
  valid_lanes(p, first, last);
  HostWarp warp{&counter, &f_min};
  std::vector<std::unique_ptr<UntilWalk<G, 32>>> walks(order.size());
  std::vector<bool> done(order.size(), first > last);
  for (bool any = true; any;) {
    any = false;
    for (uint32_t w : order) {
      if (done[w]) continue;
      if (walks[w] == nullptr) {
        if (SHARED && starts_above_hit(first, warp)) {
          done[w] = true;
          continue;
        }
        walks[w].reset(new UntilWalk<G, 32>(first, last, warp));
      } else {
        done[w] = !walks[w]->step(body, p, warp);
      }
      any = true;
    }
  }
  Key best = sentinel();
  for (const auto& w : walks) {
    for (int l = 0; w != nullptr && l < 32; ++l) {
      if (key_less(w->best[l], best)) best = w->best[l];
    }
  }
  if (SHARED) {
    printf("%u %u %u %u %u\n", f_min != ~0u ? 1u : 0u, f_min, hashed, top,
           counter);
  } else if (f_min != ~0u) {
    printf("1 %u\n", f_min);
  } else {  // no hit: every lane was visited, and best is the arg-min
    printf("0 %u %u %u %u\n", f_min, best.hi, best.lo, best.idx);
  }
}

template <template <int> class F, class... A>
static void by_variant(const Plan& p, A&&... a) {
  switch (plan_variant(p)) {
    case 0: F<0>::go(p, a...); break;
    case 1: F<1>::go(p, a...); break;
    case 2: F<2>::go(p, a...); break;
  }
}
template <int V> struct Run {
  static void go(const Plan& p, uint32_t b, uint32_t lo, uint32_t hi) {
    print_run<V>(p, b, lo, hi);
  }
};
template <int V> struct Walk {
  static void go(const Plan& p, uint32_t threads) {
    const Key k = walk<V>(p, threads);
    printf("%u %u %u\n", k.hi, k.lo, k.idx);
  }
};
template <int V> struct Until {
  static void go(const Plan& p, uint32_t grab,
                 const std::vector<uint32_t>& order, uint32_t preset,
                 bool shared) {
    if (shared) {
      if (grab == 1u) {
        until<1u, V, true>(p, order, preset);
      } else {
        until<4u, V, true>(p, order, preset);
      }
    } else if (grab == 1u) {
      until<1u, V, false>(p, order, preset);
    } else {
      until<4u, V, false>(p, order, preset);
    }
  }
};

int main() {
  char mode[16];
  int n;
  while (scanf("%15s %d", mode, &n) == 2) {
    for (int c = 0; c < n; ++c) {
      if (mode[0] == 'h') {          // helpers: x y z
        uint32_t x, y, z;
        scanf("%u %u %u", &x, &y, &z);
        printf("%u %u", fadd(x, y), fmad(x, y, z));
        for (int s = 1; s < 32; ++s) printf(" %u", rotr(x, s));
        shifts<1>(x);
        printf("\n");
      } else if (mode[0] == 'r') {   // run: plan base dlo dhi
        const Plan p = read_plan();
        uint32_t b, lo, hi;
        scanf("%u %u %u", &b, &lo, &hi);
        by_variant<Run>(p, b, lo, hi);
      } else if (mode[0] == 'w') {   // walk: plan threads
        const Plan p = read_plan();
        uint32_t threads;
        scanf("%u", &threads);
        by_variant<Walk>(p, threads);
      } else if (mode[0] == 't') {   // ties: first last threads
        uint32_t first, last, threads;
        scanf("%u %u %u", &first, &last, &threads);
        Key best = sentinel();
        for (uint32_t t = 0; t < threads; ++t) {
          Key mine = sentinel();
          walk_runs(first, last, t, threads,
                    [&](uint32_t base, uint32_t dlo, uint32_t dhi) {
                      for (uint32_t d = dlo; d <= dhi; ++d) {
                        const uint32_t i = base + d;  // the stub's hash
                        const Key c{(i / 7u) * 2654435761u % 97u, 0u, i};
                        if (key_less(c, mine)) mine = c;
                      }
                      return true;
                    });
          if (key_less(mine, best)) best = mine;
        }
        printf("%u %u %u\n", best.hi, best.lo, best.idx);
      } else {  // until: plan G warps order...; shared: plan lowest G ...
        const Plan p = read_plan();
        const bool shared = mode[0] == 'p';
        uint32_t lowest = ~0u, grab, warps;
        if (shared) scanf("%u", &lowest);
        scanf("%u %u", &grab, &warps);
        std::vector<uint32_t> order(warps);
        for (auto& w : order) scanf("%u", &w);
        by_variant<Until>(p, grab, order, lowest, shared);
      }
    }
  }
  return 0;
}
"""

#: The bodies held here: K1's rolled body, K3's and K4's.
BODIES = ("rolled", "peel", "hoist")


@pytest.fixture(scope="module")
def lane_builds(tmp_path_factory):
    """The harness compiled with each body, the ``g++`` processes all
    started at once: ``{body: (process, executable)}``."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    d = tmp_path_factory.mktemp("lanes")
    src = open(sha256_cuda.SOURCE).read()
    head = src[:src.index("// " + "-" * 60 + " kernels\n")]
    start = src.index("int plan_variant(const Plan& p) {")
    variant = src[start:src.index("\n}\n", start) + 3]
    (d / "cuda_runtime.h").write_text(_SHIM)
    (d / "lanes.inc").write_text(head + "static " + variant)
    (d / "lanes.cpp").write_text(_MAIN)
    builds = {body: (subprocess.Popen(
        [cxx, "-std=c++17", "-O1", "-w", f"-I{d}",
         f"-DDBMT_BODY={sha256_cuda.BODIES[body]}", "-o",
         str(d / f"lanes_{body}"), str(d / "lanes.cpp")]),
        d / f"lanes_{body}") for body in BODIES}
    yield builds
    for proc, _ in builds.values():
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module", params=BODIES)
def lanes_exe(request, lane_builds):
    """The harness compiled with one body: (body, executable)."""
    proc, exe = lane_builds[request.param]
    assert proc.wait(timeout=300) == 0
    return request.param, exe


def _run(exe, blocks) -> list:
    """Feed the harness ``[(mode, [line, ...]), ...]``; its output lines."""
    stdin = "".join(f"{mode} {len(lines)}\n" + "".join(
        ln + "\n" for ln in lines) for mode, lines in blocks)
    out = subprocess.run([str(exe)], input=stdin, capture_output=True,
                         text=True, check=True, timeout=120)
    return out.stdout.split("\n")[:-1]


def _tail(prefix: bytes, k: int):
    mid, tail = sha256_midstate(prefix)
    return mid, sha256_torch.build_tail_template(tail, k, len(prefix) + k)


def _plan(body, mid, tmpl, rem, k, i0=0, lo_i=0, hi_i=0, n=0, t=0):
    hoist = (sha256_torch.build_hoist(mid, tmpl, rem, k).ops
             if body == "hoist" else None)
    words = sha256_cuda.plan_array(mid, tmpl, i0, lo_i, hi_i, n, rem, k,
                                   t >> 32, t & M32, hoist=hoist).tolist()
    return " ".join(map(str, words))


def _oracle(prefix: bytes, k: int, i: int) -> tuple:
    d = hashlib.sha256(prefix + f"{i:0{k}d}".encode()).digest()
    return int.from_bytes(d[:4], "big"), int.from_bytes(d[4:8], "big")


def _rotr(x: int, s: int) -> int:
    return ((x >> s) | (x << (32 - s))) & M32


def test_pipe_helpers_equal_plain_arithmetic(lanes_exe):
    """fadd, fmad, and rotr and fshr at every shift amount, on seeded words
    (and the edges 0, 1, 2^31, 2^32 - 1), equal plain arithmetic."""
    _, exe = lanes_exe
    rng = np.random.default_rng(61)
    words = [int(x) for x in rng.integers(0, 1 << 32, size=(200, 3))
             .reshape(-1)] + [0, 1, 1 << 31, M32] * 3
    triples = [words[j:j + 3] for j in range(0, len(words) - 2, 3)]
    got = _run(exe, [("h", [" ".join(map(str, t)) for t in triples])])
    for (x, y, z), line in zip(triples, got):
        want = [(x + y) & M32, (x * y + z) & M32]
        want += [_rotr(x, s) for s in SHIFTS]
        want += [x >> s for s in SHIFTS]
        assert list(map(int, line.split())) == want


def test_lane_bodies_equal_hashlib_every_shape(lanes_exe):
    """Each body, a whole run at a time, at every rem 0-63 and k 1-9: the
    first and last runs of the digit class (cut to it) and a seeded run
    cut at both ends, every lane's key against hashlib."""
    body, exe = lanes_exe
    rng = np.random.default_rng(62)
    lines, want = [], []
    for rem in range(64):
        for k in range(1, 10):
            prefix = bytes(rng.integers(32, 127, size=64 + rem,
                                        dtype=np.uint8))
            mid, tmpl = _tail(prefix, k)
            words = _plan(body, mid, tmpl, rem, k)
            top = 10 ** k - 1
            mid_run = int(rng.integers(0, 10 ** k)) // 10 * 10
            runs = {(0, 0, min(9, top)), (top // 10 * 10, 0, top % 10),
                    (mid_run, 2, min(7, top - mid_run))}
            for base, dlo, dhi in sorted(runs):
                lines.append(f"{words} {base} {dlo} {dhi}")
                want += [f"{h} {lo} {base + d}" for d in range(dlo, dhi + 1)
                         for h, lo in [_oracle(prefix, k, base + d)]]
    assert _run(exe, [("r", lines)]) == want


#: Seeded windows: (message, k, i0, lo_i, hi_i, n); edges off the run and
#: thread edges, a window inside one run, one across a run edge, one lane,
#: and a 2-block tail whose digits spill into the second block.
WINDOWS = [("cmu440", 6, 123_451, 123_457, 124_660, 1_400),
           ("x" * 60, 9, 100_000_003, 100_000_004, 100_000_008, 7),
           ("x" * 60, 9, 123_000_001, 123_000_005, 123_001_203, 1_300),
           ("a fifty-character message; its digits stay in one.", 9,
            999_998_999, 999_999_001, 999_999_999, 1_001),
           ("cmu440", 3, 17, 17, 23, 7),
           ("mouse", 2, 45, 45, 45, 1)]


@pytest.mark.parametrize("threads", [256, 3 * 256])
def test_run_walk_equals_plain_scan_and_jax(lanes_exe, threads):
    """K1's walk over runs with a simulated grid of ``threads`` threads
    against the port's plain ``span_scan`` and the JAX package's
    ``search_span`` on the same windows."""
    body, exe = lanes_exe
    lines, want = [], []
    for data, k, i0, lo_i, hi_i, n in WINDOWS:
        prefix = data.encode() + b" "
        mid, tmpl = _tail(prefix, k)
        rem = len(prefix) % 64
        lines.append(f"{_plan(body, mid, tmpl, rem, k, i0, lo_i, hi_i, n)}"
                     f" {threads}")
        plain = tuple(int(x) & M32 for x in search.span_scan(
            mid, tmpl, i0, lo_i, hi_i, n, rem=rem, k=k,
            device="cpu").tolist())
        if threads == 256:
            ref = tuple(int(x) for x in search_span(
                np.asarray(mid, np.uint32), tmpl, np.uint32(i0),
                np.uint32(lo_i), np.uint32(hi_i), None, rem=rem, k=k,
                batch=2048, nbatches=1))
            assert ref == plain
        want.append("%d %d %d" % plain)
    assert _run(exe, [("w", lines)]) == want


def test_run_walk_earliest_nonce_wins_ties(lanes_exe):
    """A stub body whose hash is (i // 7) * 2654435761 mod 97: seven
    neighbours tie and the values repeat. Over seeded windows and three
    grid sizes the walk's minimum is the earliest lane of the lowest
    hash."""
    _, exe = lanes_exe
    rng = np.random.default_rng(63)
    lines, want = [], []
    for _ in range(40):
        first = int(rng.integers(0, 10 ** 6))
        last = first + int(rng.integers(0, 3_000))
        for threads in (1, 32, 256):
            lines.append(f"{first} {last} {threads}")
            i = np.arange(first, last + 1, dtype=np.uint64)
            h = ((i // np.uint64(7)) * np.uint64(2654435761)
                 & np.uint64(M32)) % np.uint64(97)
            j = int(np.argmin(h))
            want.append(f"{int(h[j])} 0 {first + j}")
    assert _run(exe, [("t", lines)]) == want


#: The grab sizes K2's walk is held at: the smallest (1) and the kernel's
#: (4, ``kGrab``).
GRABS = (1, 4)
#: The shape of the JAX package's until scan: it covers every window here.
_JAX_BATCH, _JAX_NBATCHES = 4_096, 2


@functools.lru_cache(maxsize=None)
def _until_want(data, k, i0, lo_i, hi_i, n, t) -> str:
    """The plain until scan's answer for a window of ``data`` as the
    harness prints it (found and f_idx, or the arg-min words when nothing
    is found), held first to the JAX package's ``search_span_until`` (jnp,
    on the CPU)."""
    prefix = data.encode() + b" "
    mid, tmpl = _tail(prefix, k)
    rem = len(prefix) % 64
    plain = [int(x) & M32 for x in search.span_until_scan(
        mid, tmpl, i0, lo_i, hi_i, n, t >> 32, t & M32, rem=rem, k=k,
        device="cpu").tolist()]
    ref = [int(x) for x in search_span_until(
        np.asarray(mid, np.uint32), tmpl, np.uint32(i0), np.uint32(lo_i),
        np.uint32(hi_i), np.uint32(t >> 32), np.uint32(t & M32), rem=rem,
        k=k, batch=_JAX_BATCH, nbatches=_JAX_NBATCHES)]
    cmp = 2 if plain[0] else 5
    assert ref[:cmp] == plain[:cmp]
    return " ".join(map(str, plain[:cmp]))


def _until_lines(body, rng, data, k, i0, lo_i, hi_i, n, t,
                 grabs=GRABS) -> tuple:
    """Harness lines for one window of ``data`` and target at each grab
    size, one and three warps, in ascending, descending and seeded warp
    orders, and the line the harness must print for each."""
    want = _until_want(data, k, i0, lo_i, hi_i, n, t)
    prefix = data.encode() + b" "
    mid, tmpl = _tail(prefix, k)
    plan = _plan(body, mid, tmpl, len(prefix) % 64, k, i0, lo_i, hi_i, n, t)
    lines = []
    for grab in grabs:
        for warps in (1, 3):
            for order in (list(range(warps)), list(range(warps))[::-1],
                          [int(x) for x in rng.permutation(warps)]):
                lines.append(f"{plan} {grab} {warps} "
                             + " ".join(map(str, order)))
    return lines, [want] * len(lines)


def test_until_walk_never_skips_the_lowest_hit(lanes_exe):
    """K2's walk (grabs of 32 x G runs, G 1 and 4, the next grab taken
    before the current one is worked, the lowest hit read a run ahead),
    its warps in several orders against one shared lowest hit: found and
    f_idx equal the plain until scan's and the JAX package's (and, when
    nothing is found, the arg-min words), on the seeded windows (shorter
    than a run among them) for a dense target, one only the window's
    arg-min meets, and one nothing meets."""
    body, exe = lanes_exe
    rng = np.random.default_rng(64)
    lines, want = [], []
    for data, k, i0, lo_i, hi_i, n in WINDOWS:
        prefix = data.encode() + b" "
        hashes = sorted(_oracle(prefix, k, i)
                        for i in range(max(lo_i, i0), min(hi_i, i0 + n - 1)
                                       + 1))
        best = hashes[0][0] << 32 | hashes[0][1]
        h_mid, l_mid = hashes[len(hashes) // 2]
        for t in (h_mid << 32 | l_mid, best + 1, 0):
            more = _until_lines(body, rng, data, k, i0, lo_i, hi_i, n, t)
            lines += more[0]
            want += more[1]
    assert _run(exe, [("u", lines)]) == want


def test_until_walk_with_a_preset_lowest_hit(lanes_exe):
    """K2's walk started with the lowest hit already stored, as a mesh
    until shard finds it when an earlier shard of its block (on its card,
    or through peer memory) has hit: over a window that lies above the
    stored hit, no warp takes a run and no lane is hashed, and the walk
    reports that hit; from a window below it, the walk still finds the
    window's first qualifier (the plain until scan's, given the same
    lowest hit) and hashes no lane above the stored hit. G 1 and 4, one
    and three warps in several orders, on the seeded windows with at
    least two qualifying lanes under a dense target."""
    body, exe = lanes_exe
    rng = np.random.default_rng(66)
    lines, checks = [], []
    for data, k, i0, lo_i, hi_i, n in WINDOWS:
        first, last = max(lo_i, i0), min(hi_i, i0 + n - 1)
        prefix = data.encode() + b" "
        keys = {i: _oracle(prefix, k, i) for i in range(first, last + 1)}
        order = sorted(keys.values())
        t_hi, t_lo = order[len(order) // 2]
        t = t_hi << 32 | t_lo
        qual = [i for i, key in keys.items() if key < (t_hi, t_lo)]
        if len(qual) < 2:
            continue
        mid, tmpl = _tail(prefix, k)
        rem = len(prefix) % 64
        plan = _plan(body, mid, tmpl, rem, k, i0, lo_i, hi_i, n, t)
        # Above: an earlier shard's hit below this window (a lane of the
        # block before `first`). Below: a later qualifying lane of this
        # window, and the window's last lane plus one.
        for lowest in (first - 1, qual[-1], last + 1):
            plain = [int(x) & M32 for x in search.span_until_scan(
                mid, tmpl, i0, lo_i, hi_i, n, t_hi, t_lo, rem=rem, k=k,
                device="cpu", lowest=lowest).tolist()]
            for grab in GRABS:
                for warps in (1, 3):
                    for ordr in (list(range(warps)),
                                 [int(x) for x in rng.permutation(warps)]):
                        lines.append(f"{plan} {lowest} {grab} {warps} "
                                     + " ".join(map(str, ordr)))
                        checks.append((first, lowest, plain[:2]))
    assert len(checks) >= 4 * 3 * 2 * 2 * 2
    for line, (first, lowest, plain) in zip(_run(exe, [("p", lines)]),
                                            checks):
        found, f_idx, hashed, top, handed = map(int, line.split())
        assert [found, f_idx] == plain
        if lowest < first:
            assert (f_idx, hashed, handed) == (lowest, 0, 0)
        else:
            assert f_idx < lowest and 0 < hashed and top <= lowest


#: Tails for the grab cases: a 1-block tail, a 2-block one whose last
#: digit lies in the second block, and one whose second block holds none.
GRAB_TAILS = (("cmu440", 6), ("x" * 60, 9),
              ("a fifty-character message; its digits stay in one.", 9))


@functools.lru_cache(maxsize=None)
def _lane_keys(data: str, k: int) -> tuple:
    """The first lane of ``data``'s k-digit class and the 64-bit hash keys
    of its first 12,000 lanes (the plain tier)."""
    import torch
    prefix = data.encode() + b" "
    mid, tmpl = _tail(prefix, k)
    lo = 10 ** (k - 1)
    hi, low = sha256_torch.hash_lanes(mid, tmpl, torch.arange(
        lo, lo + 12_000, dtype=torch.int64), len(prefix) % 64, k)
    return lo, (hi.numpy().astype(np.uint64) << np.uint64(32)) \
        | low.numpy().astype(np.uint64)


@functools.lru_cache(maxsize=None)
def _grab_cases(data: str, k: int, grab: int) -> tuple:
    """Windows of ``data`` at k digits where K2's grabs of 32 x ``grab``
    runs have edges, as (i0, lo_i, hi_i, n, target, lane the first hit
    must be or None): the first hit in the last run of the first grab (the
    grab's arg-min lies there, and the target is just above its hash), and
    a window whose last grab crosses its end (a target nothing meets, and
    one only its arg-min meets)."""
    lo, keys = _lane_keys(data, k)
    runs_a_grab = 32 * grab
    for a in range(lo + 3, lo + len(keys) - 10 * runs_a_grab, 10):
        x = a + int(np.argmin(keys[a - lo:(a // 10 + runs_a_grab) * 10 - lo]))
        if x // 10 - a // 10 == runs_a_grab - 1:
            break
    else:
        raise AssertionError("no window puts the hit in a grab's last run")
    n = 10 * (runs_a_grab + 40)
    cases = [(a - 3, a, a + n - 6, n, int(keys[x - lo]) + 1, x)]
    i0, n = lo + 10_007 - 10 * runs_a_grab, 10 * (runs_a_grab + 5) + 3
    best = int(keys[i0 - lo:i0 - lo + n].min())
    return tuple(cases + [(i0, i0, i0 + n - 1, n, t, None)
                          for t in (0, best + 1)])


@pytest.mark.parametrize("grab", GRABS)
def test_until_walk_grab_edges(lanes_exe, grab):
    """K2's walk where its grabs have edges: the first hit in the last run
    of the first grab (every earlier lane of that grab above the target),
    and a window whose last grab crosses its end (a target nothing meets,
    and one only its arg-min meets), on a 1-block tail and on both 2-block
    shapes; against the plain until scan and the JAX package's."""
    body, exe = lanes_exe
    rng = np.random.default_rng(65 + grab)
    lines, want = [], []
    for data, k in GRAB_TAILS:
        for i0, lo_i, hi_i, n, t, x in _grab_cases(data, k, grab):
            more = _until_lines(body, rng, data, k, i0, lo_i, hi_i, n, t,
                                grabs=(grab,))
            assert x is None or more[1][0] == f"1 {x}"
            lines += more[0]
            want += more[1]
    assert _run(exe, [("u", lines)]) == want
