"""dbmlint on the port: its analyzers held against the JAX package's.

Every fixture snippet of ``tests/test_lint.py`` goes through the JAX
``run_source`` as written and, re-spelled for the port (``DBMT_`` knobs,
the port's paths, torch calls, the ``nvcc`` build boundary in place of
the jit boundary), through the port's ``run_source``: both must give the
same findings (analyzer, lines, count). The port's own cases cover the
torch blocking surface, the build boundary of ``build-static``, the
knob catalogue against the package README and ``utils/config.py``, the
baseline's round trip and its refusal to grow, the tree clean against
its empty baseline, and the CLI as a subprocess that imports neither
JAX nor torch.

Pure AST, no card: the module runs in seconds.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

import test_lint as jax_fixtures
from distributed_bitcoinminer_tpu.analysis import run_source as jax_run_source
from distributed_bitcoinminer_tpu.analysis.core import \
    load_files as jax_load_files
from distributed_bitcoinminer_tpu_torch.analysis import (
    ANALYZERS, compare, load_baseline, run_repo, run_source)
from distributed_bitcoinminer_tpu_torch.analysis.core import (
    Finding, baseline_path, load_files, save_baseline)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "distributed_bitcoinminer_tpu_torch"
JAX = "distributed_bitcoinminer_tpu"


def snip(src: str) -> str:
    return textwrap.dedent(src)


# ------------------------------------------- fixtures re-spelled for the port

#: The jit boundary's fixtures as build boundaries, line for line: the
#: finding lines must equal the JAX analyzer's.
BUILD_BAD = snip("""
    import functools
    import torch

    from .sha256_cuda import build_all, load
    def search_fixture(x, *, rem, nbatches):
        return x

    def caller(x, span, batch):
        # computed INLINE at the boundary: unbounded build signatures
        return load(span // batch + 1)

    def caller_via_local(x, span, batch):
        n = span // batch            # same hazard, one assignment away
        return build_all(bodies=n)
""")

BUILD_GOOD = snip("""
    import functools
    import torch

    from . import sha256_cuda
    def search_fixture(x, *, rem, nbatches):
        return x

    BODY = "rolled"

    def caller(x, plan, body):
        # literals, module constants, precomputed plan state, and
        # forwarded parameters are the quantized-upstream shapes.
        sha256_cuda.load(BODY)
        sha256_cuda.default_grid(x, plan.body, 0, plan.variant)
        for _, b in plan.bodies:
            sha256_cuda.build(b)
        return sha256_cuda.load(body=body)
""")

BUILD_QUANTIZED = snip("""
    import functools
    import torch

    from .sha256_cuda import body_of, load

    # load(body) picks the library a launch runs
    def batch_fixture(x, *, nrows):
        return x

    def caller(x, rows):
        # A registered quantizer at the boundary: bounded by the
        # callee's contract (the three lane bodies).
        ok = load(body_of(rows.peel, None))
        # The same expression WITHOUT the quantizer stays a finding.
        return ok, load(rows.body_name())
""")

BUILD_VARIANT = snip("""
    import functools
    import torch

    from .sha256_cuda import default_grid, variant_of

    # default_grid(device, body, entry, variant) loads the body's library
    def devloop_fixture(x, nsub, *, cap):
        return x

    def caller(x, rem, k, nblocks):
        nsub = (rem + k) // nblocks
        # The tail's variant, quantized by variant_of's contract (three
        # kernel variants).
        ok = default_grid(x, "rolled", 0, variant_of(rem, k, nblocks))
        # The raw runtime count at the boundary still fails.
        return ok, default_grid(x, "rolled", 0, nsub)
""")

BUILD_FOR = {"JIT_BAD": BUILD_BAD, "JIT_GOOD": BUILD_GOOD,
             "JIT_QUANTIZED": BUILD_QUANTIZED, "JIT_DEVLOOP": BUILD_VARIANT}

#: The JAX analyzer's name -> the port's.
ANALYZER_FOR = {"jit-static": "build-static"}


def port_spelling(src: str) -> str:
    """A JAX fixture re-spelled for the port: its knobs, and the JAX
    backend probe (blocking) replaced by the port's rate probe."""
    return src.replace("DBM_", "DBMT_").replace(
        "probe_backend(3.0)", "measure_rate_hint(3.0)")


def port_rel(rel: str) -> str:
    return rel.replace(f"{JAX}/", f"{PORT}/", 1)


def _suppressed(src: str, marker: str) -> str:
    return src.replace(
        "time.sleep(1.0)                  # blocks the loop",
        f"time.sleep(1.0)  # dbmlint: ok[{marker}] test rig")


def ok_marker(src: str) -> str:
    return _suppressed(src, "loop-block")


def other_marker(src: str) -> str:
    return _suppressed(src, "cardinality")


def _lock_suppressed(src: str) -> str:
    return src.replace(
        "await asyncio.sleep(0.1)     # parked holding the lock",
        "await asyncio.sleep(0.1)  "
        "# dbmlint: ok[lock-discipline] bounded: test rig")


_APPS = f"{JAX}/apps/_fixture.py"
_OPS = f"{JAX}/ops/_fixture.py"
_UTILS = f"{JAX}/utils/_fixture.py"

#: (analyzer, fixture name in test_lint, rel in the JAX tree, transform)
CASES = [
    ("loop-block", "LOOP_BAD", _APPS, None),
    ("loop-block", "LOOP_GOOD", _APPS, None),
    ("loop-block", "LOOP_BAD", _OPS, None),
    ("loop-block", "LOOP_BAD", _APPS, ok_marker),
    ("loop-block", "LOOP_BAD", _APPS, other_marker),
    ("cardinality", "CARD_BAD", _APPS, None),
    ("cardinality", "CARD_GOOD_RETIRED", _APPS, None),
    ("cardinality", "CARD_GOOD_LITERAL", _APPS, None),
    ("cardinality", "CARD_TRACK_BAD", _APPS, None),
    ("cardinality", "CARD_TRACK_GOOD", _APPS, None),
    ("cardinality", "CARD_TRACK_WRONG_RETIREMENT", _APPS, None),
    ("cardinality", "CARD_PROC_BAD", _APPS, None),
    ("cardinality", "CARD_PROC_GOOD", _APPS, None),
    ("cardinality", "CARD_PROC_WRONG_RETIREMENT", _APPS, None),
    ("knob-hygiene", "KNOB_BAD", _APPS, None),
    ("knob-hygiene", "KNOB_GOOD", _APPS, None),
    ("knob-hygiene", "KNOB_COMPUTED", _APPS, None),
    ("knob-hygiene", "KNOB_BAD", f"{JAX}/utils/_env.py", None),
    ("jit-static", "JIT_BAD", _OPS, None),
    ("jit-static", "JIT_GOOD", _OPS, None),
    ("jit-static", "JIT_BAD", _UTILS, None),
    ("jit-static", "JIT_QUANTIZED", _OPS, None),
    ("jit-static", "JIT_DEVLOOP", _OPS, None),
    ("thread-state", "THREAD_BAD", _APPS, None),
    ("thread-state", "THREAD_GOOD_TABLE", _APPS, None),
    ("thread-state", "THREAD_BAD_LOOP_WRITE", _APPS, None),
    ("thread-state", "THREAD_GOOD_LOCK", _APPS, None),
    ("lock-discipline", "LOCK_BAD_AWAIT", _APPS, None),
    ("lock-discipline", "LOCK_BAD_BLOCKING", _APPS, None),
    ("lock-discipline", "LOCK_GOOD", _APPS, None),
    ("lock-discipline", "LOCK_BAD_AWAIT", _UTILS, None),
    ("lock-discipline", "LOCK_BAD_AWAIT", _APPS, _lock_suppressed),
]


def _case_id(case):
    analyzer, name, rel, transform = case
    where = rel.split("/")[-2]
    return f"{analyzer}-{name}-{where}" + (
        f"-{transform.__name__.strip('_')}" if transform else "")


def _shape(findings):
    return sorted((f.analyzer, f.line) for f in findings)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_port_analyzer_matches_jax_on_shared_fixture(case):
    analyzer, name, rel, transform = case
    src = getattr(jax_fixtures, name)
    if transform is not None:
        src = transform(src)
    want = jax_run_source(analyzer, src, rel=rel)
    port_analyzer = ANALYZER_FOR.get(analyzer, analyzer)
    port_src = BUILD_FOR.get(name, src) if analyzer == "jit-static" \
        else port_spelling(src)
    if transform is not None and analyzer == "jit-static":
        port_src = transform(port_src)
    got = run_source(port_analyzer, port_src, rel=port_rel(rel))
    assert _shape(got) == [(port_analyzer, ln) for _a, ln in _shape(want)]
    assert len(got) == len(want)


def test_every_jax_fixture_has_a_lockstep_case():
    """Each module-level snippet of ``tests/test_lint.py`` (an upper-case
    string constant) runs through both analyzers above."""
    snippets = {n for n, v in vars(jax_fixtures).items()
                if n.isupper() and isinstance(v, str) and "\n" in v}
    assert snippets == {name for _a, name, _r, _t in CASES}


def test_the_analyzer_catalogue():
    assert set(ANALYZERS) == {
        "loop-block", "cardinality", "knob-hygiene", "build-static",
        "thread-state", "lock-discipline", "hotpath-alloc"}


def test_build_static_keys_name_the_calling_function():
    found = run_source("build-static", BUILD_BAD,
                       rel=f"{PORT}/ops/_fixture.py")
    assert {f.key.split(":")[2] for f in found} == \
        {"caller", "caller_via_local"}
    assert {f.key.rsplit(":", 1)[-1] for f in found} == {"body", "bodies"}


# ------------------------------------------------- the torch blocking surface

@pytest.mark.parametrize("call", [
    "carry.item()", "words.tolist()", "carry.cpu()", "carry.numpy()",
    "torch.cuda.synchronize()", "stream.synchronize()", "np.asarray(words)",
    "sha256_cuda.build_all()", "sha256_cuda.load('rolled')",
    "sha256_native.build()", "alu_probe.build()",
    "NonceSearcher(data, device='cuda')", "MeshNonceSearcher(data)",
    "HostSearcher(data)", "PodSearcher(pod)",
    "default_searcher_factory(data, 'cuda')", "measure_rate_hint(s)",
    "warm_up(dev)", "run_follower()", "scan_min_native(data, 0, 9)",
    "searcher.dispatch_batch(entries)", "searcher.finalize_batch(h)",
    "self._resolve_and_dispatch_batch(msgs)", "self._search(data, 0, 9)",
    "subprocess.check_output(['nvcc'])"])
def test_loop_block_flags_the_torch_surface(call):
    src = f"async def serve(self, data, dev):\n    return {call}\n"
    found = run_source("loop-block", src, rel=f"{PORT}/apps/_fixture.py")
    assert len(found) == 1, call
    assert found[0].line == 2
    # Handed to a worker thread, the same work is off the loop.
    hop = f"async def serve(self, data, dev):\n" \
          f"    return await asyncio.to_thread(lambda: {call})\n"
    assert run_source("loop-block", hop,
                      rel=f"{PORT}/apps/_fixture.py") == []


def test_loop_block_generic_names_stay_attribute_only():
    src = snip("""
        async def serve(self, items):
            search(items)            # some local helper
            d = {k: v for k, v in items.items()}
            return d
    """)
    assert run_source("loop-block", src,
                      rel=f"{PORT}/apps/_fixture.py") == []


def test_lock_discipline_flags_a_kernel_build_under_a_lock():
    src = snip("""
        import threading
        from ..ops import sha256_cuda

        class Actor:
            def __init__(self):
                self._build_lock = threading.Lock()

            def warm(self):
                with self._build_lock:
                    sha256_cuda.build_all()
    """)
    found = run_source("lock-discipline", src,
                       rel=f"{PORT}/apps/_fixture.py")
    assert [f.key.rsplit(":", 1)[-1] for f in found] == \
        ["sha256_cuda.build_all"]


# -------------------------------------------------------- the build boundary

@pytest.mark.parametrize("src, lines", [
    # a runtime-derived body at nvcc's command line
    ("from . import sha256_cuda\n"
     "def f(body, out, n):\n"
     "    return sha256_cuda._nvcc_command(body + str(n), out)\n", [3]),
    # quantized by body_of, and the out path is not a build argument
    ("from . import sha256_cuda\n"
     "def f(peel, hoist, out):\n"
     "    return sha256_cuda._nvcc_command(sha256_cuda.body_of(peel, hoist), "
     "out + '.tmp')\n", []),
    # an aliased import still reaches the boundary
    ("from .sha256_cuda import load as lib_of\n"
     "def f(names):\n"
     "    return lib_of(names[0])\n", [3]),
    # a keyword argument, multi-assigned
    ("from . import sha256_cuda\n"
     "def f(a, b):\n"
     "    body = a\n"
     "    if b:\n"
     "        body = b\n"
     "    return sha256_cuda.build(body=body)\n", [6]),
    # the host tier's and the probe's builds take no argument: no boundary
    ("from . import sha256_native, alu_probe\n"
     "def f(x):\n"
     "    return sha256_native.build(), alu_probe.load()\n", []),
    # variant_of at the occupancy query, a subscript for its body
    ("from . import sha256_cuda\n"
     "def f(dev, bodies, rem, k, nb):\n"
     "    return sha256_cuda.default_grid(dev, bodies[0], 0, "
     "sha256_cuda.variant_of(rem, k, nb))\n", [3]),
])
def test_build_static_boundary(src, lines):
    found = run_source("build-static", src, rel=f"{PORT}/ops/_fixture.py")
    assert [f.line for f in found] == lines


def test_build_static_bare_names_inside_the_defining_module():
    """Inside ``ops/sha256_cuda.py`` itself, a bare ``load(...)`` is the
    boundary; elsewhere a bare ``load`` is some other function."""
    src = "def f(xs):\n    return load(xs[0])\n"
    assert [f.line for f in run_source(
        "build-static", src, rel=f"{PORT}/ops/sha256_cuda.py")] == [2]
    assert run_source("build-static", src,
                      rel=f"{PORT}/ops/_fixture.py") == []


def test_build_static_scope_takes_apps_not_utils():
    src = "from ..ops import sha256_cuda\n" \
          "def f(n):\n    return sha256_cuda.load(pick(n))\n"
    assert len(run_source("build-static", src,
                          rel=f"{PORT}/apps/_fixture.py")) == 1
    assert run_source("build-static", src,
                      rel=f"{PORT}/utils/_fixture.py") == []


# ------------------------------------------------------------ hotpath-alloc

HOT = snip("""
    import json

    # dbmlint: hotpath
    def encode(msg):
        return json.dumps({"k": msg})

    def slow(msg):                   # not marked: anything goes
        return json.dumps([msg])
""")


def test_hotpath_alloc_flags_marked_functions_in_lsp():
    found = run_source("hotpath-alloc", HOT, rel=f"{PORT}/lsp/_fixture.py")
    assert sorted(f.key.rsplit(":", 1)[-1] for f in found) == \
        ["dict-literal", "json.dumps"]
    assert run_source("hotpath-alloc", HOT,
                      rel=f"{PORT}/apps/_fixture.py") == []


# ----------------------------------------------- the knob catalogue, on disk

def _knob_tree(tmp_path, reads, doc, readme, root_readme=""):
    pkg = tmp_path / PORT
    (pkg / "utils").mkdir(parents=True)
    (pkg / "apps").mkdir()
    (pkg / "utils" / "config.py").write_text(f'"""{doc}"""\n')
    (pkg / "apps" / "reader.py").write_text(
        "from ..utils._env import int_env\n" + "".join(
            f"X{i} = int_env({k!r}, 1)\n" for i, k in enumerate(reads)))
    (pkg / "README.md").write_text(readme)
    (tmp_path / "README.md").write_text(root_readme)
    return str(tmp_path)


@pytest.mark.parametrize("doc, readme, root_readme, want", [
    ("DBMT_A DBMT_B", "| `DBMT_A` | `DBMT_B` |", "", []),
    # the package README, not the root one, is the knob table
    ("DBMT_A DBMT_B", "| `DBMT_A` |", "DBMT_B", ["readme-doc:DBMT_B"]),
    ("DBMT_A", "DBMT_A DBMT_B", "", ["config-doc:DBMT_B"]),
    ("DBMT_A DBMT_B DBMT_GONE", "DBMT_A DBMT_B DBMT_OLD", "",
     ["config-orphan:DBMT_GONE", "readme-orphan:DBMT_OLD"]),
    # a family reference documents nothing and is no orphan
    ("DBMT_A DBMT_B DBMT_*", "DBMT_A DBMT_B, the `DBMT_*` family", "", []),
])
def test_knobs_sync_with_config_docstring_and_package_readme(
        tmp_path, doc, readme, root_readme, want):
    repo = _knob_tree(tmp_path, ["DBMT_A", "DBMT_B"], doc, readme,
                      root_readme)
    found = run_repo(repo, only="knob-hygiene")
    assert sorted(f.key.split(":", 1)[1] for f in found) == want


def test_the_port_reads_its_knobs_only_through_the_env_helpers():
    """The port's tree reads every ``DBMT_`` knob through ``utils/_env``
    and documents each in both places (the tree's own run is clean)."""
    assert run_repo(REPO, only="knob-hygiene") == []


# ---------------------------------------------------- the scope of the scans

def test_scan_covers_the_port_and_chip_smoke_only():
    rels = {f.rel for f in load_files(REPO)}
    assert "chip_smoke.py" in rels
    assert f"{PORT}/analysis/core.py" in rels
    assert all(r.startswith(f"{PORT}/") or r == "chip_smoke.py"
               for r in rels)
    # The JAX lint's scope is its own package, bench.py and scripts/.
    jax_rels = {f.rel for f in jax_load_files(REPO)}
    assert not any(r.startswith(f"{PORT}/") or r == "chip_smoke.py"
                   for r in jax_rels)


# ------------------------------------------------------- baseline mechanics

def _finding(key):
    return Finding("loop-block", "f.py", 1, key, "msg " + key)


def test_compare_splits_new_known_stale():
    new, known, stale = compare([_finding("a"), _finding("b")],
                                {"b": "msg b", "c": "msg c"})
    assert ([f.key for f in new], [f.key for f in known], stale) == \
        (["a"], ["b"], ["c"])


def test_baseline_roundtrip(tmp_path):
    path = str(tmp_path / "baseline.json")
    save_baseline(path, [_finding("k1"), _finding("k0")])
    assert list(load_baseline(path)) == ["k0", "k1"]
    with open(path) as f:
        assert "shrink" in json.load(f)["comment"]


def _cli(*args, cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-m", f"{PORT}.tools.dbmlint",
                           *args], env=env, capture_output=True, text=True,
                          cwd=cwd, timeout=120)


def test_update_refuses_to_grow_without_force(tmp_path):
    pkg = tmp_path / PORT
    (pkg / "apps").mkdir(parents=True)
    (pkg / "analysis").mkdir()
    (pkg / "apps" / "bad.py").write_text(
        "import time\nclass W:\n    async def f(self):\n"
        "        time.sleep(1)\n")
    base = ["--repo", str(tmp_path)]
    r = _cli(*base, "--update-baseline")
    assert r.returncode == 1 and "refusing to GROW" in r.stderr
    r = _cli(*base)
    assert r.returncode == 1 and "1 NEW finding" in r.stderr
    r = _cli(*base, "--update-baseline", "--force")
    assert r.returncode == 0
    assert len(load_baseline(str(pkg / "analysis" / "baseline.json"))) == 1
    assert _cli(*base).returncode == 0         # baselined: clean now
    r = _cli(*base, "--analyzer", "cardinality", "--update-baseline")
    assert r.returncode == 2 and "requires a full run" in r.stderr
    r = _cli(*base, "--analyzer", "cardinality")
    assert r.returncode == 0 and "stale" not in r.stdout
    # Fixed: the entry is stale, and --update-baseline flushes it.
    (pkg / "apps" / "bad.py").write_text("x = 1\n")
    r = _cli(*base)
    assert r.returncode == 0 and "stale" in r.stdout
    assert _cli(*base, "--update-baseline").returncode == 0
    assert load_baseline(str(pkg / "analysis" / "baseline.json")) == {}


# ------------------------------------------------------------- the port tree

def test_port_tree_is_clean_against_its_empty_baseline():
    with open(baseline_path(REPO)) as f:
        assert json.load(f)["findings"] == {}
    findings = run_repo(REPO)
    new, _known, _stale = compare(findings, load_baseline(
        baseline_path(REPO)))
    assert new == [], "\n".join(f.render() for f in new)
    assert findings == []


def test_cli_exits_zero_on_the_tree_importing_neither_jax_nor_torch():
    code = (
        "import sys, runpy; sys.argv = ['dbmlint', '--list']; "
        "rc = 0\n"
        "try:\n"
        f"    runpy.run_module('{PORT}.tools.dbmlint', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'torch' or m.startswith('torch.') or m == '" + JAX + "' "
        "or m.startswith('" + JAX + ".')]\n"
        "print('RESULT', rc, bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "RESULT 0 []" in r.stdout, r.stdout
    assert "dbmlint: clean (no findings)" in r.stdout


def test_miner_worker_thread_shared_table_covers_its_executor_lru():
    """``MinerWorker._searchers`` is touched on ``to_thread`` workers; its
    ``THREAD_SHARED`` entry is what keeps the thread-state analyzer quiet
    once a loop-side method touches it too (the table removed, it fires)."""
    from distributed_bitcoinminer_tpu_torch.apps.miner import MinerWorker
    assert set(MinerWorker.THREAD_SHARED) == {"_searchers"}
    rel = f"{PORT}/apps/miner.py"
    with open(os.path.join(REPO, rel)) as f:
        src = f.read()
    touch = ("    async def _loop_touch(self):\n"
             "        return len(self._searchers)\n\n"
             "    def _get_searcher(self, data: str):")
    assert src.count("    def _get_searcher(self, data: str):") == 1
    touched = src.replace("    def _get_searcher(self, data: str):", touch)
    assert run_source("thread-state", touched, rel=rel) == []
    start = touched.index("    THREAD_SHARED = {")
    end = touched.index("    }\n", start) + len("    }\n")
    found = run_source("thread-state", touched[:start] + touched[end:],
                       rel=rel)
    assert [f.key.rsplit(":", 1)[-1] for f in found] == ["_searchers"]
