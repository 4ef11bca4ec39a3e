"""The host compute tier: the native C++ SHA-256 scan, loaded with ctypes.

Counterpart of the JAX package's ``native/__init__.py``. The source is
the port's own ``csrc/sha256_scan.cpp`` (SHA-NI where the CPU has it,
every core for large ranges); it is compiled with ``g++`` at first use
into ``build/``, as ``libdbmt_native-<host fingerprint>.so`` (a library
built for one host's instructions is never loaded on another), and again
whenever the source or the flags change. No library is committed.

The flags (:func:`gxx_flags`): ``-O3``, and ``-msse4.1 -msha`` where the
CPU has SHA-NI; no ``-march=native`` (the JAX package's choice): on the
host of an NVIDIA H100 machine the ``-march=native`` build scanned many
times slower than this one (its AVX-encoded code around the SSE-encoded
SHA instructions pays at every switch between the two), while on hosts
without that penalty the two scan alike.

There is no fallback: where ``g++`` is missing or the build fails,
:func:`load` raises, and so does every scan (the JAX loader answers from
the pure-Python oracle there). The tier is chosen only explicitly
(``DBMT_COMPUTE=host``, ``apps.miner.HostSearcher``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Tuple

from ..utils.config import host_fingerprint

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "sha256_scan.cpp")
BUILD_DIR = os.path.join(_PKG, "build")

#: The flags of every build; :func:`gxx_flags` adds the host's own.
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

#: Ranges at least this long fan out over every core.
MT_THRESHOLD = 1 << 17

_lock = threading.Lock()
_lib = None


def gxx_flags() -> list:
    """:data:`GXX_FLAGS`, with ``-msse4.1 -msha`` where this host's CPU
    has SHA-NI (``/proc/cpuinfo``'s flags), which the source's SHA-NI
    path needs."""
    try:
        with open("/proc/cpuinfo") as f:
            line = next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        line = ""
    have = set(line.split())
    extra = ["-msse4.1", "-msha"] if {"sha_ni", "sse4_1"} <= have else []
    return [*GXX_FLAGS, *extra]


def library_path() -> str:
    return os.path.join(BUILD_DIR,
                        f"libdbmt_native-{host_fingerprint()}.so")


def _digest() -> str:
    h = hashlib.sha256(" ".join(gxx_flags()).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def _up_to_date(lib: str) -> bool:
    stamp = lib + ".sha256"
    if not (os.path.exists(lib) and os.path.exists(stamp)):
        return False
    with open(stamp) as f:
        return f.read().strip() == _digest()


def build() -> str:
    """Compile the library unless an up-to-date one exists; returns its
    path. Raises RuntimeError when ``g++`` is missing or fails."""
    lib = library_path()
    if _up_to_date(lib):
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host compute tier "
                           "(DBMT_COMPUTE=host) builds its scan with g++")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *gxx_flags(), SOURCE, "-o", tmp],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {SOURCE}:\n"
                           f"{proc.stderr[-2000:]}")
    os.replace(tmp, lib)
    with open(lib + ".sha256", "w") as f:
        f.write(_digest())
    return lib


def load():
    """The loaded library (built on first use). Raises when it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            u64, p64 = ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)
            pint = ctypes.POINTER(ctypes.c_int)
            lib.dbmt_scan_until.restype = ctypes.c_int
            lib.dbmt_scan_until.argtypes = [ctypes.c_char_p, u64, u64, u64,
                                            u64, p64, p64, pint]
            lib.dbmt_scan_until_mt.restype = ctypes.c_int
            lib.dbmt_scan_until_mt.argtypes = [ctypes.c_char_p, u64, u64,
                                               u64, u64, ctypes.c_int, p64,
                                               p64, pint]
            _lib = lib
        return _lib


def scan_until_native(data: str, lower: int, upper: int, target: int,
                      threads: int = 0) -> Tuple[int, int, bool]:
    """Difficulty scan over ``[lower, upper]``: the first nonce whose hash
    is below ``target`` (found True), else the exact arg-min (found False;
    the earliest nonce wins a tie). ``threads``: 0 all cores for ranges of
    at least :data:`MT_THRESHOLD` and one below, 1 one, N that many; the
    answer is the same for every count (ascending shards, the lowest
    hitting shard wins)."""
    if lower > upper:
        raise ValueError("empty range")
    lib = load()
    raw = data.encode("utf-8")
    out_hash, out_nonce = ctypes.c_uint64(), ctypes.c_uint64()
    out_found = ctypes.c_int()
    if threads == 0 and upper - lower + 1 < MT_THRESHOLD:
        threads = 1
    if threads == 1:
        rc = lib.dbmt_scan_until(raw, len(raw), lower, upper, target,
                                 ctypes.byref(out_hash),
                                 ctypes.byref(out_nonce),
                                 ctypes.byref(out_found))
    else:
        rc = lib.dbmt_scan_until_mt(raw, len(raw), lower, upper, target,
                                    threads, ctypes.byref(out_hash),
                                    ctypes.byref(out_nonce),
                                    ctypes.byref(out_found))
    if rc != 0:
        raise ValueError("empty range")
    return out_hash.value, out_nonce.value, bool(out_found.value)


def scan_min_native(data: str, lower: int, upper: int,
                    threads: int = 0) -> Tuple[int, int]:
    """Arg-min scan over ``[lower, upper]``: the until scan with target 0,
    which no hash is below."""
    hash_value, nonce, _found = scan_until_native(data, lower, upper, 0,
                                                  threads=threads)
    return hash_value, nonce
