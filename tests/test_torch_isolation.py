"""The port stands alone: it loads neither JAX nor the JAX package.

A fresh interpreter imports every module of
``distributed_bitcoinminer_tpu_torch`` and ``chip_smoke.py`` and must end
with no ``jax`` and no ``distributed_bitcoinminer_tpu`` module loaded; a
source scan backs that up for code paths an import does not reach.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "distributed_bitcoinminer_tpu_torch"

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import distributed_bitcoinminer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "distributed_bitcoinminer_tpu"
             or m.startswith("distributed_bitcoinminer_tpu."))
print(json.dumps({"imported": names, "bad": bad}))
"""


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_importing_the_port_loads_no_jax():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    out = subprocess.run([sys.executable, "-c", _PROBE, str(REPO)],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(REPO), env=env)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    modules = set(report["imported"])
    for name in ("apps.server", "apps.miner", "apps.client",
                 "apps.scheduler", "apps.qos", "apps.tenant_plane",
                 "apps.miner_plane", "models.miner_model", "ops.search",
                 "ops.sha256_cuda", "ops.sha256_torch", "lsp.core",
                 "lspnet.net", "bitcoin.hash", "utils.config",
                 "utils.metrics", "utils.trace", "utils.sanitize",
                 "utils.logging", "utils.profiling", "apps.adapt",
                 "tools.trace_census", "tools.dbmtrace", "tools.tune",
                 "parallel.multihost", "apps.capture", "apps.health",
                 "apps.procs", "apps.rollup", "apps.replicas",
                 "apps.gateway", "apps.slo", "tools.dbmtop",
                 "ops.sha256_native", "lspnet.detnet", "lspnet.chaos",
                 "apps.loadharness", "apps.transportbench",
                 "tools.loadharness", "runners.srunner",
                 "runners.crunner", "analysis", "analysis.core",
                 "analysis.knobs", "analysis.loopblock",
                 "analysis.lockdiscipline", "analysis.threadstate",
                 "analysis.cardinality", "analysis.hotpathalloc",
                 "analysis.buildstatic", "analysis.schedcheck",
                 "analysis.schedcheck.detloop",
                 "analysis.schedcheck.scenario",
                 "analysis.schedcheck.scenarios",
                 "analysis.schedcheck.explore", "tools.dbmlint",
                 "tools.dbmcheck"):
        assert f"distributed_bitcoinminer_tpu_torch.{name}" in modules


def test_sources_never_name_jax_or_the_jax_package():
    imports_jax = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    names_pkg = re.compile(r"distributed_bitcoinminer_tpu(?!_torch)")
    for path in _sources():
        text = path.read_text()
        assert not imports_jax.search(text), path
        assert not names_pkg.search(text), path


def test_knobs_are_the_ports_own():
    """The port reads and names only ``DBMT_`` knobs: a ``DBM_`` setting
    meant for the JAX package never reaches it in a shared process."""
    jax_knob = re.compile(r"\bDBM_[A-Z0-9_]+")
    for path in sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu")) \
            + sorted(PKG.rglob("*.cpp")):
        assert not jax_knob.search(path.read_text()), path


def test_cuda_is_built_and_imported_only_inside_calls():
    """No module builds a kernel or imports triton at import time; the
    kernel source is CUDA C++ for sm_90a."""
    for path in _sources():
        for line in path.read_text().splitlines():
            assert not re.match(r"(import|from)\s+triton\b", line), path
    src = (PKG / "csrc" / "sha256_argmin.cu").read_text()
    assert "__global__" in src and "__funnelshift_r" in src
    from distributed_bitcoinminer_tpu_torch.ops import sha256_cuda
    assert "arch=compute_90a,code=sm_90a" in sha256_cuda.NVCC_FLAGS
    assert sha256_cuda._libs == {}


def test_host_library_is_built_from_the_ports_own_source():
    """The host tier's scan is the port's ``csrc/sha256_scan.cpp``, built
    into the port's ``build/`` as ``libdbmt_native-*.so``: nothing of the
    port names the JAX package's committed ``libdbm_native-*.so`` or its
    ``native/`` loader, and the entry points are the port's own."""
    from distributed_bitcoinminer_tpu_torch.ops import sha256_native
    assert pathlib.Path(sha256_native.SOURCE) == PKG / "csrc" / \
        "sha256_scan.cpp"
    assert pathlib.Path(sha256_native.BUILD_DIR) == PKG / "build"
    lib = pathlib.Path(sha256_native.library_path())
    assert lib.parent == PKG / "build"
    assert re.fullmatch(r"libdbmt_native-[0-9a-f]{12}\.so", lib.name)
    src = (PKG / "csrc" / "sha256_scan.cpp").read_text()
    assert "int dbmt_scan_until_mt(" in src
    assert not re.search(r"\bdbm_scan", src)
    for path in _sources():
        text = path.read_text()
        assert "libdbm_native" not in text, path
        assert not re.search(r"\bnative\.(scan|load|available)", text), path
    assert not list(PKG.rglob("*.so")) or all(
        p.parent == PKG / "build" for p in PKG.rglob("*.so"))
