"""K7, the INT32 ALU ceiling probe: build, load and launch it, and its
plain version.

``csrc/alu_probe.cu`` replaces the JAX package's
``scripts/tpu_tune.py::vpu_kernel``, the tuning tool's synthetic ALU
probe: 8 rotate-xor-add chains per lane, ``iters`` iterations, the xor of
the chains written once per lane. It is compiled by ``nvcc`` for
``sm_90a`` into ``build/`` at first use (again when the source changes)
and loaded with ``ctypes``. :func:`alu_probe` launches it on a CUDA
device; :func:`alu_probe_plain` is its plain PyTorch version, in int64
lanes masked to 32 bits (PyTorch on the CPU has no uint32 arithmetic).
``tools.tune`` times it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import torch

from . import sha256_cuda

SOURCE = os.path.join(os.path.dirname(sha256_cuda.SOURCE), "alu_probe.cu")
LIBRARY = os.path.join(sha256_cuda.BUILD_DIR, "libdbmt_alu_probe.so")
#: The TPU script's iterations per lane and its count of operations an
#: iteration: 8 chains x (2 shifts, or, xor, 2 adds).
ITERS = 2000
OPS_PER_ITER = 48
M32 = 0xFFFFFFFF

#: Launches of the probe kernel, counted where :func:`alu_probe` launches.
launches = {"K7": 0}
#: The last build: seconds, nvcc's ptxas report, whether it ran.
build_info: dict = {}

_lib = []
_lock = threading.Lock()


def _digest() -> str:
    h = hashlib.sha256(" ".join(sha256_cuda.NVCC_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def build() -> str:
    """Compile the probe's library unless an up-to-date one exists;
    returns its path. Raises RuntimeError when nvcc fails."""
    stamp = LIBRARY + ".sha256"
    if os.path.exists(LIBRARY) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == _digest():
                build_info.setdefault("built", False)
                return LIBRARY
    os.makedirs(sha256_cuda.BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    t0 = time.monotonic()
    out = subprocess.run([sha256_cuda._nvcc(), *sha256_cuda.NVCC_FLAGS,
                          "-o", tmp, SOURCE], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc {SOURCE} failed ({out.returncode}):\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, LIBRARY)
    with open(stamp, "w") as f:
        f.write(_digest())
    build_info.update(built=True, seconds=time.monotonic() - t0,
                      ptxas=out.stderr.strip())
    return LIBRARY


def load():
    """The loaded probe library (built on first use)."""
    with _lock:
        if not _lib:
            lib = ctypes.CDLL(build())
            lib.dbmt_alu_probe.argtypes = [ctypes.c_uint32, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_void_p]
            for fn in (lib.dbmt_alu_probe, lib.dbmt_alu_probe_threads,
                       lib.dbmt_alu_probe_blocks_per_sm):
                fn.restype = ctypes.c_int
            _lib.append(lib)
        return _lib[0]


def wave(device) -> int:
    """Blocks of one full wave: SMs x resident probe blocks per SM."""
    per_sm = load().dbmt_alu_probe_blocks_per_sm()
    if per_sm <= 0:
        raise RuntimeError("cudaOccupancyMaxActiveBlocksPerMultiprocessor "
                           "failed for the ALU probe")
    return torch.cuda.get_device_properties(
        torch.device(device)).multi_processor_count * per_sm


def threads() -> int:
    return load().dbmt_alu_probe_threads()


def alu_probe(grid: int, iters: int = ITERS, *, device) -> torch.Tensor:
    """K7 over ``grid`` blocks on the current stream of the CUDA
    ``device``: a ``(grid * threads(),)`` int32 tensor of the lanes' uint32
    values. Nothing is synchronised. Any device but a CUDA one raises."""
    device = sha256_cuda._cuda_device(device, "alu_probe")
    lib = load()
    out = torch.empty(int(grid) * lib.dbmt_alu_probe_threads(),
                      dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.dbmt_alu_probe(iters & M32, int(grid), out.data_ptr(),
                                 stream)
    if err != 0:
        raise RuntimeError(f"dbmt_alu_probe launch failed: cudaError {err}")
    launches["K7"] += 1
    return out


def alu_probe_plain(lanes: int, iters: int = ITERS, *,
                    device="cpu") -> torch.Tensor:
    """Plain version of K7: lane j's value, its 8 chains started at
    ``j % 128 + c``, as a ``(lanes,)`` int64 tensor of uint32 words on
    ``device``."""
    col = torch.arange(lanes, dtype=torch.int64, device=device) % 128
    x = col[None, :] + torch.arange(8, dtype=torch.int64,
                                    device=device)[:, None]
    for i in range(iters):
        r = ((x >> 7) | (x << 25)) & M32
        x = ((r ^ x) + (i + x)) & M32
    acc = x[0]
    for c in range(1, 8):
        acc = acc ^ x[c]
    return acc
