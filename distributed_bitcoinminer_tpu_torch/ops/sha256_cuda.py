"""The CUDA SHA-256 search kernels: build, load and launch.

``csrc/sha256_argmin.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/libdbmt_kernels.so`` at first use (again whenever the source
changes) and loaded with ``ctypes``; its plain C entries take the plan as
a host pointer, so a launch copies nothing to the device. The wrappers
take CUDA tensors only: there is no fallback here.

- :func:`sha256_argmin` (K1) replaces the JAX package's
  ``ops/sha256_pallas.py::pallas_search_span``; its plain version is
  ``ops.search.span_scan``.
- :func:`sha256_until` (K2) replaces ``pallas_search_span_until``; its
  plain version is ``ops.search.span_until_scan``.
- :func:`sha256_segmin` (K5) replaces ``pallas_search_span_batch`` (via
  ``pallas_segmin``), the batched segment-min of coalesced launches; its
  plain version is ``ops.search.span_segmin_scan``.
- :func:`sha256_argmin_fold` and :func:`sha256_until_fold` (K6) replace
  the single-device devloop entries ``_pallas_devloop_span_jit`` and
  ``_pallas_devloop_until_jit``; their plain versions are the scans above
  followed by ``ops.searchop.fold_argmin`` / ``fold_until``.

``ops.search`` routes between each kernel and its plain version by
device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "sha256_argmin.cu")
BUILD_DIR = os.path.join(_PKG, "build")
LIBRARY = os.path.join(BUILD_DIR, "libdbmt_kernels.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
PLAN_WORDS = 49
M32 = 0xFFFFFFFF

#: Kernel launches by the TPU kernel each replaces, counted where a wrapper
#: launches them. Every call launches a search kernel and then a one-block
#: reduce of its partials: K1's search counts under K1, K2's (plain or
#: chained) under K2, and each reduce under its own wrapper's kernel, so a
#: K6 call counts one search launch (K1 or K2) and one fold launch (K6).
#: A K5 call counts each kernel it launches: one search launch per tail
#: block count among its rows and the segment reduce.
launches = {"K1": 0, "K2": 0, "K5": 0, "K6": 0}
#: The last build's facts: seconds, nvcc's ptxas report, whether it ran.
build_info: dict = {}

_lib = None
_lock = threading.Lock()
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_ENTRIES = {
    "dbmt_sha256_argmin": [_P, _P, _P, _I, _P],
    "dbmt_sha256_until": [_P, _P, _P, _P, _I, _P],
    "dbmt_sha256_argmin_fold": [_P, _P, _P, _U, _U, _I, _P],
    "dbmt_sha256_until_fold": [_P, _P, _P, _P, _U, _U, _I, _P],
    "dbmt_sha256_argmin_blocks_per_sm": [_I],
    "dbmt_sha256_until_blocks_per_sm": [_I],
    "dbmt_sha256_argmin_threads": [],
    "dbmt_sha256_segmin": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "dbmt_sha256_segmin_blocks_per_sm": [_I],
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def total_launches() -> int:
    return sum(launches.values())


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernel needs the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def build() -> str:
    """Compile the kernel library unless an up-to-date one exists;
    returns its path. Raises RuntimeError when nvcc fails."""
    digest = _source_digest()
    stamp = LIBRARY + ".sha256"
    if os.path.exists(LIBRARY) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                build_info.update(built=False, seconds=0.0)
                return LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    t0 = time.monotonic()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)
    with open(stamp, "w") as f:
        f.write(digest)
    build_info.update(built=True, seconds=time.monotonic() - t0,
                      ptxas=proc.stderr.strip())
    return LIBRARY


def load():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def default_grid(device: torch.device, nblocks: int,
                 until: bool = False, entry: str | None = None) -> int:
    """One full wave of the search kernel: SMs x resident blocks per SM
    (``entry``: the C entry reporting them, default K1's or K2's)."""
    lib = load()
    entry = entry or ("dbmt_sha256_until_blocks_per_sm" if until
                      else "dbmt_sha256_argmin_blocks_per_sm")
    per_sm = getattr(lib, entry)(nblocks)
    if per_sm <= 0:
        raise RuntimeError("cudaOccupancyMaxActiveBlocksPerMultiprocessor "
                           "failed for the sha256 search kernel")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * per_sm


def plan_words(midstate, template, i0: int, lo_i: int, hi_i: int, n: int,
               rem: int, k: int, t_hi: int = 0, t_lo: int = 0) -> list[int]:
    """The kernels' 49-word parameter block (see ``struct Plan``); the
    target words are read by K2 and the until chain only."""
    nblocks = int(template.shape[0])
    tmpl = [int(x) for x in template.reshape(-1)] + [0] * (16 * (2 - nblocks))
    words = ([int(m) for m in midstate] + tmpl
             + [rem, k, nblocks, i0, lo_i, hi_i, n, t_hi, t_lo])
    assert len(words) == PLAN_WORDS
    return words


def _cuda_device(device, what: str) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{what} runs on a CUDA device, not {device}")
    return device


def _launch(reduce_kernel: str, entry: str, midstate, template, i0: int,
            lo_i: int, hi_i: int, n: int, rem: int, k: int,
            device: torch.device, grid, *, until: bool, out_words: int = 0,
            carry=None, target: tuple = (0, 0), base: int | None = None):
    """Allocate the scratch, call the C entry ``entry`` on the current
    stream of ``device``, raise on a nonzero cudaError, count the search
    launch (K2 when ``until``, else K1) and the reduce launch under
    ``reduce_kernel``. Returns the new output tensor (``out_words`` > 0)."""
    if not (0 < n <= 1 << 31 and i0 + n - 1 <= M32):
        raise ValueError(f"lane window out of range: i0={i0} n={n}")
    lib = load()
    nblocks = int(template.shape[0])
    if grid is None:
        grid = default_grid(device, nblocks, until=until)
    threads = lib.dbmt_sha256_argmin_threads()
    grid = max(1, min(int(grid), -(-n // threads)))
    # partials (3 words a block), then f_min for the until kernels.
    scratch = torch.empty(3 * grid + until, dtype=torch.int32, device=device)
    args = [scratch.data_ptr()]
    if until:
        args.append(scratch[3 * grid:].data_ptr())
    out = None
    if out_words:
        out = torch.empty(out_words, dtype=torch.int32, device=device)
        args.append(out.data_ptr())
    if carry is not None:
        args += [carry.data_ptr(), base >> 32 & M32, base & M32]
    words = (ctypes.c_uint32 * PLAN_WORDS)(
        *plan_words(midstate, template, i0, lo_i, hi_i, n, rem, k, *target))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(ctypes.addressof(words), *args, grid,
                                  stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    launches["K2" if until else "K1"] += 1
    launches[reduce_kernel] += 1
    return out


def _check_carry(carry, words: int, device: torch.device) -> None:
    if not (isinstance(carry, torch.Tensor) and carry.is_cuda
            and device.index in (None, carry.device.index)
            and carry.dtype == torch.int32 and carry.shape == (words,)
            and carry.is_contiguous()):
        raise ValueError(f"the carry must be a contiguous ({words},) int32 "
                         f"tensor on {device}")


def sha256_argmin(midstate, template, i0: int, lo_i: int, hi_i: int,
                  n: int, *, rem: int, k: int, device,
                  grid: int | None = None) -> torch.Tensor:
    """K1 over lanes ``i0 + [0, n)`` masked to ``[lo_i, hi_i]`` on the
    current stream of the CUDA ``device``.

    Returns a (3,) int32 tensor on the device holding the uint32 words
    ``(hi, lo, idx)``; the all-ones sentinel means no lane was valid.
    Nothing is synchronised. ``grid`` overrides the block count (the
    answer does not depend on it). Any device but a CUDA one raises.
    """
    device = _cuda_device(device, "sha256_argmin")
    return _launch("K1", "dbmt_sha256_argmin", midstate, template, i0, lo_i,
                   hi_i, n, rem, k, device, grid, until=False, out_words=3)


def sha256_until(midstate, template, i0: int, lo_i: int, hi_i: int, n: int,
                 t_hi: int, t_lo: int, *, rem: int, k: int, device,
                 grid: int | None = None) -> torch.Tensor:
    """K2: K1's lanes with the 64-bit target ``(t_hi, t_lo)``.

    Returns a (5,) int32 tensor on the device holding the uint32 words
    ``(found, f_idx, best_hi, best_lo, best_idx)``: ``f_idx`` is the
    lowest valid lane whose hash is below the target (all-ones when
    ``found`` is 0). ``best_*`` is the lanes' arg-min, meaningful only
    when ``found`` is 0. Nothing is synchronised.
    """
    device = _cuda_device(device, "sha256_until")
    return _launch("K2", "dbmt_sha256_until", midstate, template, i0, lo_i,
                   hi_i, n, rem, k, device, grid, until=True, out_words=5,
                   target=(t_hi, t_lo))


def sha256_argmin_fold(midstate, template, carry: torch.Tensor, i0: int,
                       lo_i: int, hi_i: int, n: int, base: int, *, rem: int,
                       k: int, device, grid: int | None = None
                       ) -> torch.Tensor:
    """K6, arg-min: K1's search, its winner folded into ``carry`` (a (5,)
    int32 device tensor in the ``ops.searchop`` layout) in place, the
    nonce being ``base + lane``. Returns ``carry``; nothing is
    synchronised."""
    device = _cuda_device(device, "sha256_argmin_fold")
    _check_carry(carry, 5, device)
    _launch("K6", "dbmt_sha256_argmin_fold", midstate, template, i0, lo_i,
            hi_i, n, rem, k, device, grid, until=False, carry=carry,
            base=base)
    return carry


def sha256_until_fold(midstate, template, carry: torch.Tensor, i0: int,
                      lo_i: int, hi_i: int, n: int, t_hi: int, t_lo: int,
                      base: int, *, rem: int, k: int, device,
                      grid: int | None = None) -> torch.Tensor:
    """K6, until: K2's search folded into ``carry`` (a (8,) int32 device
    tensor in the ``ops.searchop`` until layout) in place. When
    ``carry[0]`` says an earlier launch of the chain hit, the launch does
    no lane work and leaves the carry as it is. Returns ``carry``;
    nothing is synchronised."""
    device = _cuda_device(device, "sha256_until_fold")
    _check_carry(carry, 8, device)
    _launch("K6", "dbmt_sha256_until_fold", midstate, template, i0, lo_i,
            hi_i, n, rem, k, device, grid, until=True, carry=carry,
            target=(t_hi, t_lo), base=base)
    return carry


def _segmin_blocks(lanes: list[int], grid: int, threads: int) -> list[int]:
    """Blocks of each row of one tail-block-count group: a share of the
    ``grid`` blocks proportional to the row's valid lanes, at least one
    for a row with a valid lane, never more than its lanes fill, none for
    a row without one."""
    total = sum(lanes)
    out = []
    for v in lanes:
        if v <= 0:
            out.append(0)
            continue
        out.append(max(1, min(-(-v // threads), round(grid * v / total))))
    return out


def sha256_segmin(rows, seg, *, device,
                  grid: int | None = None) -> torch.Tensor:
    """K5 over ``rows``, each ``(midstate, template, i0, lo_i, hi_i, n,
    rem, k)`` (K1's lanes ``i0 + [0, n)`` masked to ``[lo_i, hi_i]``),
    reduced per segment; ``seg`` gives each row's segment id, ascending
    from 0.

    Returns a (3, S) int32 tensor on the CUDA ``device`` holding the
    uint32 words ``(seg_hi, seg_lo, seg_idx)`` of the S = ``seg[-1] + 1``
    segments, the lexicographic minimum over each segment's valid lanes
    (the all-ones sentinel for a segment without one). Rows may differ in
    message, rem, k and lanes; the plans travel to the device in one
    copy. Nothing is synchronised. ``grid`` overrides the blocks of each
    search launch (the answer does not depend on it), which are divided
    among its rows by :func:`_segmin_blocks`. Any device but a CUDA one
    raises.
    """
    import numpy as np
    device = _cuda_device(device, "sha256_segmin")
    rows, seg = list(rows), [int(x) for x in seg]
    if not rows or len(seg) != len(rows) or seg[0] < 0 \
            or any(b < a for a, b in zip(seg, seg[1:])):
        raise ValueError("sha256_segmin needs rows with ascending segment "
                         "ids from 0, one per row")
    lib = load()
    threads = lib.dbmt_sha256_argmin_threads()
    nrows, nsegs = len(rows), seg[-1] + 1
    words, lanes, groups = [], [], {1: [], 2: []}
    for r, (mid, tmpl, i0, lo_i, hi_i, n, rem, k) in enumerate(rows):
        nb = int(tmpl.shape[0])
        if not (0 < n <= 1 << 31 and i0 + n - 1 <= M32 and nb in (1, 2)
                and 1 <= k <= 9 and 0 <= rem <= 63):
            raise ValueError(f"row {r} out of range: i0={i0} n={n} "
                             f"nblocks={nb} rem={rem} k={k}")
        words += plan_words(mid, tmpl, i0, lo_i, hi_i, n, rem, k)
        lanes.append(max(0, min(hi_i, i0 + n - 1) - max(lo_i, i0) + 1))
        groups[nb].append(r)
    pstart, pcount = [0] * nrows, [0] * nrows
    group_words, grids, base = [], [], 0
    for nb in (1, 2):
        members, blocks = groups[nb], []
        if members:
            g = grid if grid is not None else default_grid(
                device, nb, entry="dbmt_sha256_segmin_blocks_per_sm")
            blocks = _segmin_blocks([lanes[r] for r in members],
                                    max(1, int(g)), threads)
        g_rows, g_blk = [], [0]
        for r, b in zip(members, blocks):
            if b:
                pstart[r], pcount[r] = base + g_blk[-1], b
                g_rows.append(r)
                g_blk.append(g_blk[-1] + b)
        group_words.append((g_rows, g_blk))
        grids.append(g_blk[-1])
        base += g_blk[-1]
    seg_rows = [0] * (nsegs + 1)
    for s in seg:
        seg_rows[s + 1] += 1
    for s in range(nsegs):
        seg_rows[s + 1] += seg_rows[s]
    (g1_rows, g1_blk), (g2_rows, g2_blk) = group_words
    table = np.asarray(words + pstart + pcount + seg_rows + g1_rows + g1_blk
                       + g2_rows + g2_blk, dtype=np.int64)
    table = torch.from_numpy(table.astype(np.uint32).view(np.int32)).to(
        device)
    scratch = torch.empty(max(3, 3 * base), dtype=torch.int32, device=device)
    out = torch.empty((3, nsegs), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.dbmt_sha256_segmin(
            table.data_ptr(), nrows, nsegs, len(g1_rows), grids[0],
            len(g2_rows), grids[1], scratch.data_ptr(), out.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"dbmt_sha256_segmin launch failed: cudaError "
                           f"{err}")
    launches["K5"] += sum(1 for g in grids if g) + 1
    return out
