"""The CUDA SHA-256 search kernels: build, load and launch.

``csrc/sha256_argmin.cu`` is compiled by ``nvcc`` for ``sm_90a`` once per
lane body (:data:`BODIES`: ``-DDBMT_BODY``) into ``build/`` at first use
(again whenever the source changes; :func:`build_all` runs the three
``nvcc`` at once) and loaded with ``ctypes``; its plain C entries take
the plan as a host pointer, so a launch copies nothing to the device.
The wrappers take CUDA tensors only: there is no fallback here.

Every search wrapper takes ``peel`` and ``hoist``: ``peel=True`` launches
the peeled body, K3 (the JAX package's peel branch of ``_kernel_body``,
peel on and hoist off), or, with a hoist (``HoistPlan.ops`` from
``ops.sha256_torch.build_hoist``), K4 (``_peel_hoisted``). K3 computes
K1's function from K1's operands, so its plain version is the plain scan
of the same entry; K4's is that scan through the hoisted compression
(``hash_lanes(..., hoist=...)``).

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
- K6's mesh bodies replace ``pallas_devloop_scan`` and
  ``pallas_devloop_until_scan`` with the merge and fold around them
  (``parallel/mesh_search.py`` in the JAX package): each shard runs
  :func:`sha256_argmin` (into its row of the fold's input) or
  :func:`sha256_until_shard` (K2's search chained on its card's carry,
  sharing the block's lowest-hit word with the card's other shards and,
  through peer memory, with the mesh's other cards) over its window, and
  :func:`mesh_fold_argmin` / :func:`mesh_fold_until` merge the shards'
  rows into a device's carry; their plain versions are
  ``parallel.mesh_search.fold_rows_argmin`` / ``fold_rows_until``.
  :func:`k6_fold` launches K6's reduce-and-fold alone, to time it.

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

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "sha256_argmin.cu")
BUILD_DIR = os.path.join(_PKG, "build")
#: The lane bodies, by name: their ``DBMT_BODY`` value and library.
BODIES = {"rolled": 0, "peel": 1, "hoist": 2}
LIBRARIES = {"rolled": os.path.join(BUILD_DIR, "libdbmt_kernels.so"),
             "peel": os.path.join(BUILD_DIR, "libdbmt_kernels_peel.so"),
             "hoist": os.path.join(BUILD_DIR, "libdbmt_kernels_hoist.so")}
LIBRARY = LIBRARIES["rolled"]
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
PLAN_WORDS = 49
#: K4's plan: the 49 words, then the hoist section in the TPU kernel's
#: order, deep (8), kw (2 x 16), cw (2 x 16), ckw (64), a 1-block tail's
#: second rows and an absent ckw zero.
HOIST_PLAN_WORDS = PLAN_WORDS + 8 + 32 + 32 + 64
#: Lanes per run (``kRun``): a search thread takes whole runs of this many
#: consecutive lanes, which share every digit but the last.
RUN_LANES = 10
#: Threads of a search block (``kThreads``).
THREADS = 256
M32 = 0xFFFFFFFF

#: Kernel launches by the TPU kernel each replaces, counted where a wrapper
#: launches them. Every call launches a search kernel and then a one-block
#: reduce of its partials: the search counts under K1 (arg-min) or K2
#: (until, plain or chained), or under K3 or K4 when it runs a peeled
#: body, and each reduce under its own wrapper's kernel, so a K6 call
#: counts one search launch (K1, K2, K3 or K4) and one fold launch (K6).
#: A K5 call counts each kernel it launches: one search launch per tail
#: shape (variant) among its rows (K5, or K3 or K4 under a peeled body)
#: and the segment reduce (K5). A mesh shard's search and reduce into its row
#: count as a K1 or K2 call does; each mesh fold counts under ``K6mesh``.
launches = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0,
            "K6mesh": 0}
#: The last build of each body: seconds, nvcc's ptxas report, whether it
#: ran.
build_info: dict = {}

_libs: dict = {}
_grids: dict = {}   # default_grid's answers
_lock = threading.Lock()
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_ENTRIES = {
    "dbmt_sha256_argmin": [_P, _P, _P, _I, _P],
    "dbmt_sha256_until": [_P, _P, _P, _P, _I, _P],
    "dbmt_sha256_argmin_fold": [_P, _P, _P, _U, _U, _I, _P],
    "dbmt_sha256_until_fold": [_P, _P, _P, _P, _U, _U, _I, _P],
    "dbmt_sha256_blocks_per_sm": [_I, _I],
    "dbmt_sha256_argmin_threads": [],
    "dbmt_sha256_run_lanes": [],
    "dbmt_sha256_body": [],
    "dbmt_sha256_plan_words": [],
    "dbmt_sha256_segmin": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                           _P],
    "dbmt_sha256_until_shard": [_P, _P, _P, _I, _P, _I, _P, _P, _I, _P],
    "dbmt_k6_fold": [_P, _I, _P, _P, _U, _U, _P],
    "dbmt_mesh_fold_argmin": [_P, _I, _P, _U, _U, _P],
    "dbmt_mesh_fold_until": [_P, _I, _P, _U, _U, _P],
    "dbmt_enable_peer_access": [_I, _I],
}
#: Shards a mesh fold takes at most (``kMeshRowsMax`` in the source).
MESH_ROWS_MAX = 1024
#: Other cards' lowest-hit words a mesh until shard lowers at most
#: (``kMaxPeers``).
MAX_PEERS = 7
#: dbmt_sha256_blocks_per_sm's entry numbers.
ENTRY_ARGMIN, ENTRY_UNTIL, ENTRY_SEGMIN = 0, 1, 2
#: The counter of a search launch under each body (None: the entry's own,
#: K1 or K2 or K5).
SEARCH_KERNEL = {"rolled": None, "peel": "K3", "hoist": "K4"}


def body_of(peel: bool, hoist) -> str:
    """The lane body a search runs: K4 with a hoist (which only the
    peeled body takes), K3 for ``peel`` alone, else the rolled one."""
    if hoist is not None and not peel:
        raise ValueError("a hoist feeds the peeled body only (peel=True)")
    return "hoist" if hoist is not None else "peel" if peel else "rolled"


def variant_of(rem: int, k: int, nblocks: int) -> int:
    """The search kernels' variant for a tail (``plan_variant`` in the
    source), under every body: 0 one block, 1 two with the last digit in
    the second, 2 two with a digit-free second block."""
    if nblocks == 1:
        return 0
    return 2 if (rem + k - 1) >> 2 <= 15 else 1


def runs(i0: int, lo_i: int, hi_i: int, n: int) -> int:
    """The runs of :data:`RUN_LANES` lanes (``walk_runs`` in the source)
    that cover the valid lanes of ``i0 + [0, n)`` masked to ``[lo_i,
    hi_i]``: a search launch's units of work (0 when no lane is valid)."""
    first, last = max(lo_i, i0), min(hi_i, i0 + n - 1)
    return 0 if n <= 0 or first > last else \
        last // RUN_LANES - first // RUN_LANES + 1


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


def _nvcc_command(body: str, out: str) -> list:
    return [_nvcc(), *NVCC_FLAGS, f"-DDBMT_BODY={BODIES[body]}", "-o", out,
            SOURCE]


def _source_digest(body: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(f"DBMT_BODY={BODIES[body]}".encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def _up_to_date(body: str) -> bool:
    lib, stamp = LIBRARIES[body], LIBRARIES[body] + ".sha256"
    if not (os.path.exists(lib) and os.path.exists(stamp)):
        return False
    with open(stamp) as f:
        return f.read().strip() == _source_digest(body)


def build_all(bodies=tuple(BODIES)) -> dict:
    """Compile every body's library that is not up to date, one ``nvcc``
    process each, all started together; returns ``{body: path}``. Raises
    RuntimeError when an nvcc fails."""
    stale = [b for b in bodies if not _up_to_date(b)]
    for b in bodies:
        if b not in stale:   # keep the facts of this process's build
            build_info.setdefault(b, {"built": False, "seconds": 0.0})
    if stale:
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.monotonic()
        procs = {}
        for b in stale:
            tmp = f"{LIBRARIES[b]}.{os.getpid()}.tmp"
            procs[b] = (tmp, subprocess.Popen(
                _nvcc_command(b, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        failed = []
        for b, (tmp, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc -DDBMT_BODY={BODIES[b]} failed "
                              f"({proc.returncode}):\n{out}{err}")
                continue
            os.replace(tmp, LIBRARIES[b])
            with open(LIBRARIES[b] + ".sha256", "w") as f:
                f.write(_source_digest(b))
            build_info[b] = {"built": True,
                             "seconds": time.monotonic() - t0,
                             "ptxas": err.strip()}
        if failed:
            raise RuntimeError("\n".join(failed))
    return {b: LIBRARIES[b] for b in bodies}


def build(body: str = "rolled") -> str:
    """Compile one body's library unless an up-to-date one exists;
    returns its path. Raises RuntimeError when nvcc fails."""
    return build_all((body,))[body]


def load(body: str = "rolled"):
    """The loaded kernel library of a lane body (built on first use)."""
    with _lock:
        lib = _libs.get(body)
        if lib is None:
            lib = ctypes.CDLL(build(body))
            for name, argtypes in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            words = HOIST_PLAN_WORDS if body == "hoist" else PLAN_WORDS
            if lib.dbmt_sha256_body() != BODIES[body] \
                    or lib.dbmt_sha256_plan_words() != words \
                    or lib.dbmt_sha256_run_lanes() != RUN_LANES \
                    or lib.dbmt_sha256_argmin_threads() != THREADS:
                raise RuntimeError(f"{LIBRARIES[body]} holds another body")
            _libs[body] = lib
        return lib


def default_grid(device: torch.device, body: str, entry: int,
                 variant: int) -> int:
    """One full wave of a search kernel: SMs x its resident blocks per SM
    (``entry``: ``ENTRY_ARGMIN``, ``ENTRY_UNTIL`` or ``ENTRY_SEGMIN``),
    asked of the library once per device and kernel."""
    lib = load(body)
    key = (lib, torch.device(device), entry, variant)
    grid = _grids.get(key)
    if grid is None:
        per_sm = lib.dbmt_sha256_blocks_per_sm(entry, variant)
        if per_sm <= 0:
            raise RuntimeError("cudaOccupancyMaxActiveBlocksPerMultiprocessor"
                               " failed for the sha256 search kernel")
        grid = _grids[key] = per_sm * torch.cuda.get_device_properties(
            device).multi_processor_count
    return grid


def plan_array(midstate, template, i0: int, lo_i: int, hi_i: int, n: int,
               rem: int, k: int, t_hi: int = 0, t_lo: int = 0,
               hoist=None):
    """The kernels' parameter block (see ``struct Plan``) as a numpy
    uint32 vector: the one row of :func:`plan_table` for this plan, with
    the target ``(t_hi, t_lo)`` that K2 and the until chain read. 49
    words, or with ``hoist`` (the operand dict of
    ``ops.sha256_torch.build_hoist``) K4's 185."""
    row = (midstate, template, i0, lo_i, hi_i, n, rem, k) + (
        () if hoist is None else (hoist,))
    return plan_table([row], targets=[(t_hi, t_lo)])[0]


def _cuda_device(device, what: str) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{what} runs on a CUDA device, not {device}")
    return device


def _launch(reduce_kernel: str, entry: str, midstate, template, i0: int,
            lo_i: int, hi_i: int, n: int, rem: int, k: int,
            device: torch.device, grid, *, until: bool, peel: bool, hoist,
            tail: list, target: tuple = (0, 0), f_min=None) -> None:
    """Allocate the scratch, call the C entry ``entry`` of the body's
    library on the current stream of ``device`` with the plan, the scratch
    pointers (for the until kernels the lowest hit and run counter after
    the partials, or ``f_min``'s two words when given) and then ``tail``
    (the entry's output and carry arguments), raise on a nonzero
    cudaError, count the search launch (K3 or K4 under a peeled body, else
    K2 when ``until``, else K1) and the reduce launch under
    ``reduce_kernel``."""
    if not (0 < n <= 1 << 31 and i0 + n - 1 <= M32):
        raise ValueError(f"lane window out of range: i0={i0} n={n}")
    body = body_of(peel, hoist)
    lib = load(body)
    nblocks = int(template.shape[0])
    if grid is None:
        grid = default_grid(device, body,
                            ENTRY_UNTIL if until else ENTRY_ARGMIN,
                            variant_of(rem, k, nblocks))
    grid = max(1, min(int(grid), -(-runs(i0, lo_i, hi_i, n) // THREADS)))
    # partials (3 words a block), then for the until kernels the lowest
    # hit and the complement of the runs handed out.
    own_words = until and f_min is None
    scratch = torch.empty(3 * grid + 2 * own_words, dtype=torch.int32,
                          device=device)
    args = [scratch.data_ptr()]
    if until:
        args.append(args[0] + 4 * 3 * grid if own_words
                    else f_min.data_ptr())
    args += tail
    plan = plan_array(midstate, template, i0, lo_i, hi_i, n, rem, k,
                      *target, hoist=hoist)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(plan.ctypes.data, *args, grid, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    launches[SEARCH_KERNEL[body] or ("K2" if until else "K1")] += 1
    launches[reduce_kernel] += 1


def _check_words(t, words: int, device: torch.device, what: str) -> None:
    if not (isinstance(t, torch.Tensor) and t.is_cuda
            and device.index in (None, t.device.index)
            and t.dtype == torch.int32 and t.shape == (words,)
            and t.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous ({words},) int32 "
                         f"tensor on {device}")


def _check_carry(carry, words: int, device: torch.device) -> None:
    _check_words(carry, words, device, "the carry")


def _out(out, words: int, device: torch.device) -> torch.Tensor:
    """``out`` (checked: a row of a mesh fold's input), or a new
    ``(words,)`` int32 tensor on ``device``."""
    if out is None:
        return torch.empty(words, dtype=torch.int32, device=device)
    _check_words(out, words, device, "out")
    return out


def _base_words(base: int) -> list:
    return [base >> 32 & M32, base & M32]


def _peer_words(tensors) -> tuple:
    """``tensors`` (at most :data:`MAX_PEERS` (1,) int32 CUDA tensors on
    other cards) as the C entry takes them: a ctypes array of their
    pointers and its length."""
    tensors = list(tensors)
    if len(tensors) > MAX_PEERS or not all(
            isinstance(w, torch.Tensor) and w.is_cuda
            and w.dtype == torch.int32 and w.shape == (1,)
            for w in tensors):
        raise ValueError(f"peers must be at most {MAX_PEERS} (1,) int32 "
                         f"CUDA tensors")
    return (ctypes.c_void_p * max(1, len(tensors)))(
        *(w.data_ptr() for w in tensors)), len(tensors)


def sha256_argmin(midstate, template, i0: int, lo_i: int, hi_i: int,
                  n: int, *, rem: int, k: int, device,
                  grid: int | None = None, peel: bool = False,
                  hoist=None, out=None) -> torch.Tensor:
    """K1 (K3 with ``peel``, K4 with ``peel`` and a ``hoist``) over lanes
    ``i0 + [0, n)`` masked to ``[lo_i, hi_i]`` on the current stream of
    the CUDA ``device``.

    Returns a (3,) int32 tensor on the device holding the uint32 words
    ``(hi, lo, idx)``, written into ``out`` when given (a mesh shard's row
    of the mesh fold's input); the all-ones sentinel means no lane was
    valid. Nothing is synchronised. ``grid`` overrides the block count
    (the answer does not depend on it). Any device but a CUDA one raises.
    """
    device = _cuda_device(device, "sha256_argmin")
    out = _out(out, 3, device)
    _launch("K1", "dbmt_sha256_argmin", midstate, template, i0, lo_i, hi_i,
            n, rem, k, device, grid, until=False, peel=peel, hoist=hoist,
            tail=[out.data_ptr()])
    return out


def sha256_until(midstate, template, i0: int, lo_i: int, hi_i: int, n: int,
                 t_hi: int, t_lo: int, *, rem: int, k: int, device,
                 grid: int | None = None, peel: bool = False,
                 hoist=None) -> torch.Tensor:
    """K2 (its search under K3 or K4 as for :func:`sha256_argmin`): K1's
    lanes with the 64-bit target ``(t_hi, t_lo)``.

    Returns a (5,) int32 tensor on the device holding the uint32 words
    ``(found, f_idx, best_hi, best_lo, best_idx)``: ``f_idx`` is the
    lowest valid lane whose hash is below the target (all-ones when
    ``found`` is 0). ``best_*`` is the lanes' arg-min, meaningful only
    when ``found`` is 0. Nothing is synchronised.
    """
    device = _cuda_device(device, "sha256_until")
    out = _out(None, 5, device)
    _launch("K2", "dbmt_sha256_until", midstate, template, i0, lo_i, hi_i, n,
            rem, k, device, grid, until=True, peel=peel, hoist=hoist,
            tail=[out.data_ptr()], target=(t_hi, t_lo))
    return out


def sha256_argmin_fold(midstate, template, carry: torch.Tensor, i0: int,
                       lo_i: int, hi_i: int, n: int, base: int, *, rem: int,
                       k: int, device, grid: int | None = None,
                       peel: bool = False, hoist=None) -> torch.Tensor:
    """K6, arg-min: K1's search (K3's or K4's as for
    :func:`sha256_argmin`), its winner folded into ``carry`` (a (5,)
    int32 device tensor in the ``ops.searchop`` layout) in place, the
    nonce being ``base + lane``. Returns ``carry``; nothing is
    synchronised."""
    device = _cuda_device(device, "sha256_argmin_fold")
    _check_carry(carry, 5, device)
    _launch("K6", "dbmt_sha256_argmin_fold", midstate, template, i0, lo_i,
            hi_i, n, rem, k, device, grid, until=False, peel=peel,
            hoist=hoist, tail=[carry.data_ptr(), *_base_words(base)])
    return carry


def sha256_until_fold(midstate, template, carry: torch.Tensor, i0: int,
                      lo_i: int, hi_i: int, n: int, t_hi: int, t_lo: int,
                      base: int, *, rem: int, k: int, device,
                      grid: int | None = None, peel: bool = False,
                      hoist=None) -> torch.Tensor:
    """K6, until: K2's search (K3's or K4's) folded into ``carry`` (a
    (8,) int32 device tensor in the ``ops.searchop`` until layout) in
    place. When ``carry[0]`` says an earlier launch of the chain hit, the
    launch does no lane work and leaves the carry as it is. Returns
    ``carry``; nothing is synchronised."""
    device = _cuda_device(device, "sha256_until_fold")
    _check_carry(carry, 8, device)
    _launch("K6", "dbmt_sha256_until_fold", midstate, template, i0, lo_i,
            hi_i, n, rem, k, device, grid, until=True, peel=peel,
            hoist=hoist, tail=[carry.data_ptr(), *_base_words(base)],
            target=(t_hi, t_lo))
    return carry


def sha256_until_shard(midstate, template, carry: torch.Tensor, i0: int,
                       lo_i: int, hi_i: int, n: int, t_hi: int, t_lo: int,
                       *, rem: int, k: int, device, hit: torch.Tensor,
                       first: bool = True, peers=(), grid: int | None = None,
                       peel: bool = False, hoist=None,
                       out=None) -> torch.Tensor:
    """K6's mesh until body for one shard: K2's search (K3's or K4's)
    over the shard's lanes, in the block's lane coordinates, chained on
    ``carry`` (this device's (8,) int32 copy of the mesh's until carry):
    once ``carry[0]`` says an earlier block hit, the launch does no lane
    work.

    ``hit``: this card's (2,) int32 words of the block, the lowest hit
    that the block's shards on this card share and the run counter of the
    launch (``parallel.mesh_search.MeshSpan``). The launch resets the
    counter, and with ``first`` (the block's first shard on this card)
    the lowest hit, to all-ones on the stream before its search; a shard
    whose lanes lie above a hit already stored takes no run and hashes
    no lane. ``peers``: the lowest-hit words ((1,) int32 tensors) of the
    mesh's other cards, which each hit of this shard also lowers through
    peer memory (peer access enabled, :func:`enable_peer_access`).

    Returns the shard's (5,) int32 row ``(found, f_idx, best_hi, best_lo,
    best_idx)``, written into ``out`` when given: ``found`` and ``f_idx``
    from the card's lowest-hit word as the reduce reads it (the lowest
    hit of this shard or of an earlier one that shares the word), the
    ``best_*`` words as :func:`sha256_until` gives them, meaningful only
    when ``found`` is 0; ``(0, all-ones x 4)`` after a hit. Nothing is
    folded or synchronised."""
    device = _cuda_device(device, "sha256_until_shard")
    _check_carry(carry, 8, device)
    _check_words(hit, 2, device, "hit")
    words, npeers = _peer_words(peers)
    out = _out(out, 5, device)
    _launch("K2", "dbmt_sha256_until_shard", midstate, template, i0,
            lo_i, hi_i, n, rem, k, device, grid, until=True, peel=peel,
            hoist=hoist, f_min=hit,
            tail=[int(first), ctypes.addressof(words), npeers,
                  carry.data_ptr(), out.data_ptr()],
            target=(t_hi, t_lo))
    return out


def k6_fold(partials: torch.Tensor, carry: torch.Tensor, base: int, *,
            device, f_min=None, body: str = "rolled") -> torch.Tensor:
    """K6's reduce-and-fold kernel alone, the second launch of
    :func:`sha256_argmin_fold` (or, with ``f_min``, of
    :func:`sha256_until_fold`): the minimum of ``partials`` (a (3 x
    count,) int32 device tensor of (hi, lo, idx) keys) folded into
    ``carry`` (5 words; 8 with ``f_min``, the launch's (1,) lowest hit) in
    place. The chain never calls it: it times that kernel by itself.
    Counts under ``K6``; nothing is synchronised."""
    device = _cuda_device(device, "k6_fold")
    _check_carry(carry, 5 if f_min is None else 8, device)
    for t, what in ((partials, "partials"), (f_min, "f_min")):
        if t is not None and not (t.is_cuda and t.device == carry.device
                                  and t.dtype == torch.int32
                                  and t.is_contiguous() and t.numel()):
            raise ValueError(f"{what} must be a contiguous int32 tensor "
                             f"beside the carry")
    if partials.numel() % 3:
        raise ValueError("partials hold 3 words a block")
    lib = load(body)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.dbmt_k6_fold(partials.data_ptr(), partials.numel() // 3,
                               None if f_min is None else f_min.data_ptr(),
                               carry.data_ptr(), *_base_words(base), stream)
    if err != 0:
        raise RuntimeError(f"dbmt_k6_fold launch failed: cudaError {err}")
    launches["K6"] += 1
    return carry


_peer_access: set = set()


def enable_peer_access(device, peer, body: str = "rolled") -> None:
    """Let kernels on the CUDA ``device`` write ``peer``'s memory through
    peer pointers (``cudaDeviceEnablePeerAccess``; once a pair per
    process). Raises when the runtime refuses; ask
    ``torch.cuda.can_device_access_peer`` first."""
    a = _cuda_device(device, "peer access").index
    b = _cuda_device(peer, "peer access").index
    if (a, b) in _peer_access:
        return
    err = load(body).dbmt_enable_peer_access(a, b)
    if err != 0:
        raise RuntimeError(f"cudaDeviceEnablePeerAccess({a} -> {b}) "
                           f"failed: cudaError {err}")
    _peer_access.add((a, b))


def _mesh_fold(entry: str, rows, width: int, carry, words: int, base: int,
               device, body: str) -> torch.Tensor:
    device = _cuda_device(device, entry)
    _check_carry(carry, words, device)
    if not (isinstance(rows, torch.Tensor) and rows.is_cuda
            and rows.device == carry.device and rows.dtype == torch.int32
            and rows.dim() == 2 and rows.shape[1] == width
            and 1 <= rows.shape[0] <= MESH_ROWS_MAX
            and rows.is_contiguous()):
        raise ValueError(f"the rows must be a contiguous (n, {width}) int32 "
                         f"tensor beside the carry, 1 <= n <= "
                         f"{MESH_ROWS_MAX}")
    lib = load(body)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(rows.data_ptr(), int(rows.shape[0]),
                                  carry.data_ptr(), *_base_words(base),
                                  stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    launches["K6mesh"] += 1
    return carry


def mesh_fold_argmin(rows: torch.Tensor, carry: torch.Tensor, base: int, *,
                     device, body: str = "rolled") -> torch.Tensor:
    """K6's mesh fold, arg-min: the exact lexicographic minimum of the
    shards' ``(hi, lo, idx)`` rows (an (n, 3) int32 device tensor, shard
    order; all-ones for an empty shard) folded into ``carry`` (the (5,)
    int32 arg-min carry on the same device) in place, the nonce being
    ``base + idx``. ``body`` names the library to launch from (the one the
    shards' searches use). Returns ``carry``; nothing is synchronised."""
    return _mesh_fold("dbmt_mesh_fold_argmin", rows, 3, carry, 5, base,
                      device, body)


def mesh_fold_until(rows: torch.Tensor, carry: torch.Tensor, base: int, *,
                    device, body: str = "rolled") -> torch.Tensor:
    """K6's mesh fold, until: the shards' (n, 5) rows ``(found, f_idx,
    best_hi, best_lo, best_idx)`` merged, the lowest ``f_idx`` and the
    arg-min fallback, and folded into ``carry`` (the (8,) int32 until
    carry) in place; a carry that says found stays as it is. Returns
    ``carry``; nothing is synchronised."""
    return _mesh_fold("dbmt_mesh_fold_until", rows, 5, carry, 8, base,
                      device, body)


def _segmin_blocks(work, grid: int, threads: int) -> list[int]:
    """Blocks of each row of one group, ``grid`` at most in all (one wave
    of the group's kernel, unless it has more rows than that): one for a
    row with a valid lane whose share of ``grid`` in proportion to its
    runs of valid lanes (:func:`runs`) is below one, and the blocks left
    to the other rows in proportion to their runs, rounded down, at least
    one and never more than their runs fill; none for a row without a
    valid lane."""
    total = sum(work)
    small = [w > 0 and grid * w < total for w in work]
    rest = [w for w, s in zip(work, small) if w > 0 and not s]
    left = max(len(rest), grid - sum(small))
    rest_work = max(1, sum(rest))
    return [1 if s else 0 if w <= 0 else
            max(1, min(-(-w // threads), left * w // rest_work))
            for w, s in zip(work, small)]


_ZEROS = np.zeros(64, dtype=np.uint32)


def plan_table(rows, targets=None) -> np.ndarray:
    """The plans of ``rows``, each ``(midstate, template, i0, lo_i, hi_i,
    n, rem, k[, hoist])``, as one ``(R, words)`` uint32 array; the one
    owner of the plan's layout (``struct Plan``): the midstate (8 words),
    the tail template (32, a 1-block tail's second block zero), ``rem, k,
    nblocks, i0, lo_i, hi_i, n``, and the target ``t_hi, t_lo``
    (``targets``, one pair a row; 0 by default), 49 words; when the rows
    carry their hoist (all of them, or none), K4's 185, the hoist section
    in the TPU kernel's order: deep (8), kw (2 x 16), cw (2 x 16), ckw
    (64; zero when absent), a 1-block tail's second rows zero. Only the 16
    ``cw`` words per block travel: a deep window's ``cw2`` is not read, as
    on the TPU. The 49 words go through one Python list and the hoists
    through one concatenate: at a few dozen rows either is faster than
    numpy passes over the rows."""
    hoists = [r[8] if len(r) > 8 else None for r in rows]
    if len({h is None for h in hoists}) > 1:
        raise ValueError("sha256_segmin rows must all carry a hoist, or "
                         "none")
    words = []
    for r, row in enumerate(rows):
        mid, tmpl, i0, lo_i, hi_i, n, rem, k = row[:8]
        words += mid
        words += np.asarray(tmpl).reshape(-1).tolist()
        if tmpl.shape[0] == 1:
            words += _ZERO_WORDS
        words += (rem, k, tmpl.shape[0], i0, lo_i, hi_i, n)
        words += targets[r] if targets is not None else (0, 0)
    table = np.array(words, dtype=np.uint32).reshape(len(rows), PLAN_WORDS)
    if hoists[0] is None:
        return table
    parts = []
    for row, h in zip(rows, hoists):
        rem, k, nb = row[6], row[7], row[1].shape[0]
        ckw = nb == 2 and (rem + k - 1) >> 2 < 16
        if h["kw"].shape != (nb, 16) or h["cw"].shape != (nb, 16) \
                or ("ckw" in h) != ckw:
            raise ValueError("the hoist does not match the tail's shape")
        pad = (_ZEROS[:16],) if nb == 1 else ()
        parts += [h["deep"], h["kw"].reshape(-1), *pad,
                  h["cw"].reshape(-1), *pad, h["ckw"] if ckw else _ZEROS]
    return np.concatenate([table, np.concatenate(parts).reshape(
        len(rows), HOIST_PLAN_WORDS - PLAN_WORDS)], axis=1)


_ZERO_WORDS = [0] * 16


class SegminTable:
    """K5's host table (``SegminTable`` in the source) as numpy uint32
    ``words``: the rows' plans (:func:`plan_table`), each row's partial
    slots (``pstart``, ``pcount``), where each segment's rows begin
    (``seg_rows``), then per group, the rows of one tail shape (the
    variant, :func:`variant_of`), its rows and their block prefix.
    ``counts`` and ``grids`` are each group's rows and blocks."""

    def __init__(self, words, nrows: int, nsegs: int, counts: tuple,
                 grids: tuple):
        self.words, self.nrows, self.nsegs = words, nrows, nsegs
        self.counts, self.grids = counts, grids


def segmin_table(rows, seg, grid_of, threads: int = THREADS) -> SegminTable:
    """Build K5's host table for ``rows`` and ``seg`` (as
    :func:`sha256_segmin` takes them) without a device, in one pass over
    the rows: the rows of variant v share ``grid_of(v)`` blocks (asked
    only for a group with rows) in proportion to their runs of valid
    lanes (:func:`_segmin_blocks`). Raises ValueError on a row out of
    range."""
    rows, seg = list(rows), [int(s) for s in seg]
    if not rows or len(seg) != len(rows) or seg[0] < 0 \
            or any(b < a for a, b in zip(seg, seg[1:])):
        raise ValueError("sha256_segmin needs rows with ascending segment "
                         "ids from 0, one per row")
    members, work = ([], [], []), []
    for r, row in enumerate(rows):
        i0, lo_i, hi_i, n, rem, k = row[2:8]
        nb = row[1].shape[0]
        if not (0 < n <= 1 << 31 and 0 <= i0 and i0 + n - 1 <= M32
                and 1 <= k <= 9 and 0 <= rem <= 63
                and nb == (1 if rem + k + 9 <= 64 else 2)):
            raise ValueError(f"row {r} out of range: i0={i0} n={n} "
                             f"nblocks={nb} rem={rem} k={k}")
        work.append(runs(i0, lo_i, hi_i, n))
        members[variant_of(rem, k, nb)].append(r)
    plans = plan_table(rows)
    nrows, nsegs = len(rows), seg[-1] + 1
    pstart, pcount = [0] * nrows, [0] * nrows
    groups, counts, grids, base = [], [], [], 0
    for v in range(3):
        blocks = _segmin_blocks([work[r] for r in members[v]],
                                max(1, int(grid_of(v))), threads) \
            if members[v] else []
        g_rows, g_blk = [], [0]
        for r, b in zip(members[v], blocks):
            if b:
                pstart[r], pcount[r] = base + g_blk[-1], b
                g_rows.append(r)
                g_blk.append(g_blk[-1] + b)
        groups += g_rows + g_blk
        counts.append(len(g_rows))
        grids.append(g_blk[-1])
        base += g_blk[-1]
    seg_rows = [0] * (nsegs + 1)
    for s in seg:
        seg_rows[s + 1] += 1
    for s in range(nsegs):
        seg_rows[s + 1] += seg_rows[s]
    words = np.concatenate([plans.reshape(-1), np.array(
        pstart + pcount + seg_rows + groups, dtype=np.uint32)])
    return SegminTable(words, nrows, nsegs, tuple(counts), tuple(grids))


class SegminBatch:
    """One K5 batch with its host work done (:func:`prepare_segmin`): the
    table on the device, the scratch and the output. :meth:`launch`
    enqueues the search launches and the segment reduce."""

    def __init__(self, lib, body: str, device, table: SegminTable,
                 words: torch.Tensor, scratch: torch.Tensor,
                 out: torch.Tensor):
        self.lib, self.body, self.device, self.out = lib, body, device, out
        self.grids = table.grids
        self.args = (words.data_ptr(), table.nrows, table.nsegs,
                     *(x for g in zip(table.counts, table.grids) for x in g),
                     scratch.data_ptr(), out.data_ptr())
        self._keep = (words, scratch)   # what the pointers in args address

    def launch(self) -> torch.Tensor:
        """Enqueue the batch on the device's current stream; returns the
        (3, S) output (see :func:`sha256_segmin`). Raises on a nonzero
        cudaError."""
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = self.lib.dbmt_sha256_segmin(*self.args, stream)
        if err != 0:
            raise RuntimeError(f"dbmt_sha256_segmin launch failed: "
                               f"cudaError {err}")
        launches[SEARCH_KERNEL[self.body] or "K5"] += sum(
            1 for g in self.grids if g)
        launches["K5"] += 1
        return self.out


def prepare_segmin(rows, seg, *, device, grid: int | None = None,
                   peel: bool = False) -> SegminBatch:
    """The host work of :func:`sha256_segmin` (the same arguments): the
    table (:func:`segmin_table`, each group's blocks one full wave of its
    kernel unless ``grid`` is given) copied to the CUDA ``device``, the
    scratch and the output; nothing is launched."""
    device = _cuda_device(device, "sha256_segmin")
    rows = list(rows)
    body = body_of(peel, rows[0][8] if rows and len(rows[0]) > 8 else None)
    table = segmin_table(rows, seg, lambda v: grid if grid is not None
                         else default_grid(device, body, ENTRY_SEGMIN, v))
    lib = load(body)
    words = torch.from_numpy(table.words.view(np.int32)).to(device)
    scratch = torch.empty(max(3, 3 * sum(table.grids)), dtype=torch.int32,
                          device=device)
    out = torch.empty((3, table.nsegs), dtype=torch.int32, device=device)
    return SegminBatch(lib, body, device, table, words, scratch, out)


def sha256_segmin(rows, seg, *, device, grid: int | None = None,
                  peel: bool = False) -> torch.Tensor:
    """K5 over ``rows``, each ``(midstate, template, i0, lo_i, hi_i, n,
    rem, k[, hoist])`` (K1's lanes ``i0 + [0, n)`` masked to ``[lo_i,
    hi_i]``), reduced per segment; ``seg`` gives each row's segment id,
    ascending from 0. With ``peel`` the rows' lanes run the peeled body:
    K4 when the rows carry their hoist (all of them, or none: K3).

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
    return prepare_segmin(rows, seg, device=device, grid=grid,
                          peel=peel).launch()
