"""One block of a span over a mesh of devices: a search per shard, then the
merge of the shards' results folded into the chain's carry.

Counterpart of the JAX package's ``parallel/mesh_search.py``, cut to the
devloop shape the port uses everywhere (its ``mesh_devloop_span`` and
``mesh_devloop_span_until``; the pow2-sub chain and the sharded entries
are left out, ROADMAP). A mesh is a tuple of ``torch.device``s, one per
shard; a device may repeat (several shards on one card, the port's
counterpart of the JAX test suite's virtual CPU devices). For each aligned
10^k block:

1. :func:`~.partition.device_windows` cuts the block's valid window into
   one contiguous, ascending, even window per shard; trailing shards of a
   narrow window get none and launch nothing;
2. each shard searches its window on its device and reduces it into its
   row: K1's search (K3's, K4's) in the arg-min chain
   (``ops.sha256_cuda.sha256_argmin``); in the until chain K2's
   search chained on its device's carry, which does no lane work once
   that carry says found (``sha256_until_shard``). The until shards of a
   block share its lowest hit (:class:`MeshSpan`): one word per card,
   which every shard there reads and lowers, and which across cards each
   hit also lowers on every other card through peer memory
   (:func:`hit_scope` ``"mesh"``; ``"card"`` where a pair of cards has no
   peer access). The windows ascend, so a shard that starts above a
   stored hit hashes no lane: the block stops at its first hit as a
   single-device launch does, where the TPU's lockstep shards each scan
   their whole window;
3. the rows are merged into the exact lexicographic ``(hash_hi, hash_lo,
   idx)`` minimum, the staged pmins of the JAX package's
   ``_pmin_lex_argmin`` (until: also the lowest first hit; the windows
   ascend with the shard, so that is the first qualifying lane), and
4. folded into the chain's carry, of which each distinct device of the
   mesh holds a copy (the TPU's replicated carry): every device gets the n
   rows (a copy between cards is ordered on both devices' current streams,
   with no host synchronisation) and folds them itself, one launch of the
   mesh fold kernel. On one card the rows need no copy and the fold runs
   once.

A card resets its lowest-hit word before the block's first shard there,
on its stream, after its fold of the block before, which waited for
every shard of that block on every card; so no late hit of one block can
land in the next block's word (:func:`_cuda_block`).

The span crosses the host once, as one fetch of the first device's carry.
On a CUDA mesh every step is a kernel (``ops.sha256_cuda``); on a CPU mesh
(``("cpu",) * n``) the plain scans per shard (the until scans passing the
lowest hit on from shard to shard, the plain version of the shared word),
:func:`mesh_lex_min` and the plain folds :func:`fold_rows_argmin` and
:func:`fold_rows_until` (the mesh fold kernels' plain versions). A mesh of
mixed device types raises.

A pod (``parallel.multihost``: several processes as one miner) runs
the same block on each rank over the pod's global mesh (the ``pod=``
argument of both chains): every rank cuts the block over all the pod's
shards, searches its own windows, and one gather of every rank's rows
precedes each rank's folds. With no pod the one-process mesh above is
unchanged; the pod is a layer over it.
"""

from __future__ import annotations

import torch

from ..ops import searchop, sha256_cuda
from ..ops.search import devloop_carry, span_scan, span_until_scan
from ..ops.sha256_torch import M32
from .partition import device_windows

#: The neutral carries of the mesh chains: the single-device layouts.
mesh_carry_init = searchop.carry_init
mesh_until_carry_init = searchop.until_carry_init


def make_mesh(n_devices: int | None = None, devices=None) -> tuple:
    """The mesh: ``devices`` (names or ``torch.device``s; default every
    visible CUDA device), cut to the first ``n_devices``. Each entry
    resolves as a searcher's device does (asking for CUDA without a card
    raises); ``cuda`` without an index is the current card."""
    from ..models.miner_model import resolve_device
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("torch finds no CUDA device for the mesh; "
                               "pass devices=['cpu', ...] to search on the "
                               "CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = []
    for d in devices:
        d = resolve_device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        mesh.append(d)
    mesh = tuple(mesh[:n_devices] if n_devices is not None else mesh)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def distinct(devices) -> tuple:
    """The mesh's distinct devices in order of first appearance: the
    holders of the carry's copies."""
    return tuple(dict.fromkeys(devices))


def mesh_carry(op: searchop.SearchOp, devices) -> tuple:
    """``op``'s neutral carry on each distinct device of the mesh."""
    return tuple(devloop_carry(op, d) for d in distinct(devices))


def mesh_lex_min(rows: torch.Tensor, until: bool = False) -> torch.Tensor:
    """Plain merge of the shards' rows (one per shard, in shard order;
    words of any integer type, masked to 32 bits): ``(n, 3)`` rows
    ``(hi, lo, idx)`` give the exact lexicographic minimum as a (3,) int64
    tensor, by three staged minima (hi, then lo among the hi ties, then idx
    among both), so the lowest idx wins a hash tie and an all-ones row
    never beats a valid one. With ``until``, ``(n, 5)`` rows ``(found,
    f_idx, hi, lo, idx)`` give ``(found, min f_idx, hi, lo, idx)``."""
    rows = rows.to(torch.int64) & M32
    hi, lo, idx = rows[:, -3], rows[:, -2], rows[:, -1]
    min_hi = hi.min()
    on_hi = hi == min_hi
    min_lo = torch.where(on_hi, lo, M32).min()
    min_idx = torch.where(on_hi & (lo == min_lo), idx, M32).min()
    best = torch.stack([min_hi, min_lo, min_idx])
    if not until:
        return best
    f_idx = rows[:, 1].min()
    return torch.cat([torch.stack([(f_idx != M32).to(torch.int64), f_idx]),
                      best])


def fold_rows_argmin(carry: torch.Tensor, rows: torch.Tensor,
                     base: int) -> torch.Tensor:
    """Plain version of the arg-min mesh fold: the rows' minimum folded
    into the 5-word ``carry`` (nonce = ``base + idx``). Returns a new
    int64 carry."""
    hi, lo, idx = mesh_lex_min(rows)
    return searchop.fold_argmin(carry.to(torch.int64) & M32, hi, lo, idx,
                                base >> 32, base & M32)


def fold_rows_until(carry: torch.Tensor, rows: torch.Tensor,
                    base: int) -> torch.Tensor:
    """Plain version of the until mesh fold: the rows' lowest ``f_idx`` and
    arg-min fallback folded into the 8-word ``carry``, which stays as it
    is once it says found. Returns a new int64 carry."""
    carry = carry.to(torch.int64) & M32
    _found, f_idx, hi, lo, idx = mesh_lex_min(rows, until=True)
    folded = searchop.fold_until(carry, f_idx, hi, lo, idx, base >> 32,
                                 base & M32)
    return torch.where(carry[0] != 0, carry, folded)


def _mesh_type(devices) -> str:
    kinds = {torch.device(d).type for d in devices}
    if len(kinds) == 1 and kinds <= {"cuda", "cpu"}:
        return kinds.pop()
    raise ValueError(f"no mesh search for devices {tuple(devices)}")


def _windows(lo_i: int, hi_i: int, n: int) -> list:
    """``[(shard, lo, hi)]`` of the shards whose window holds a lane, in
    shard order (the empty ones are the trailing shards)."""
    _, lo_d, hi_d, _ = device_windows(lo_i, hi_i, n, 1)
    return [(s, int(lo_d[s]), int(hi_d[s])) for s in range(n)
            if lo_d[s] <= hi_d[s]]


class MeshSpan:
    """The until chain's lowest-hit words on a CUDA mesh, made once a span
    and handed to each of its blocks.

    ``words[t]``: holder ``t``'s (2,) int32 tensor, the lowest hit of the
    current until block on that card (shared by the block's shards
    there) and the run counter of its current shard launch; all-ones at
    first, both reset by the shard launches (``sha256_until_shard``).
    ``hit_peers[t]``: in ``"mesh"`` scope across cards, the other
    holders' lowest-hit words, which the shards on ``t`` also lower;
    peer access between the cards is enabled here (once a pair per
    process). ``body``: the library that enables it."""

    def __init__(self, devices, scope: str, body: str = "rolled"):
        holders = distinct(devices)
        peers = scope == "mesh" and len(holders) > 1
        if peers:
            for a in holders:
                for b in holders:
                    if a != b:
                        sha256_cuda.enable_peer_access(a, b, body=body)
        self.words = {t: torch.full((2,), -1, dtype=torch.int32, device=t)
                      for t in holders}
        self.hit_peers = {t: [self.words[u][:1] for u in holders if u != t]
                          if peers else [] for t in holders}


def hit_scope(devices) -> str:
    """Where a mesh's until shards' hits reach: ``"mesh"`` when every
    shard sees every other's (one card, a CPU mesh, or cards that can
    all reach each other's memory), else ``"card"``: each card's shards
    share their card's word only."""
    holders = distinct(devices)
    if len(holders) == 1 or _mesh_type(devices) == "cpu":
        return "mesh"
    if len(holders) - 1 > sha256_cuda.MAX_PEERS or not all(
            torch.cuda.can_device_access_peer(a, b)
            for a in holders for b in holders if a != b):
        return "card"
    return "mesh"


def _cuda_block(devices: tuple, carries: tuple, windows: list, width: int,
                search, fold) -> tuple:
    """One block on a CUDA mesh: ``search(device, row, carry, lo, hi,
    first)`` per shard with a window, writing its row of its device's rows
    tensor (``first``: the block's first shard on that device); then on
    every distinct device the other devices' rows copied in and
    ``fold(rows, carry, device)``. Each copy is ordered on both cards'
    streams, so a card's fold of block b waits for every shard of b on
    every card, and the card's work on block b + 1 (its lowest-hit word's
    reset first) comes after that fold. An empty shard's row is all-ones,
    with found 0 in the until layout."""
    n, holders = len(devices), distinct(devices)
    rows = {}
    for t in holders:
        rows[t] = torch.empty((n, width), dtype=torch.int32, device=t)
        if len(windows) < n:
            rows[t][len(windows):] = -1
            if width == 5:
                rows[t][len(windows):, 0] = 0
    seen = set()
    for s, lo, hi in windows:
        d = devices[s]
        search(d, rows[d][s], carries[holders.index(d)], lo, hi,
               d not in seen)
        seen.add(d)
    for t, carry in zip(holders, carries):
        for s, _, _ in windows:
            if devices[s] != t:
                rows[t][s].copy_(rows[devices[s]][s], non_blocking=True)
        fold(rows[t], carry, t)
    return carries


def shard_windows(lo_i: int, hi_i: int, n_local: int, pod) -> list:
    """This rank's ``[(local shard, lo, hi)]``: the shards with a lane
    among the ``device_windows`` cut over all the pod's ``world *
    n_local`` shards, global shard ``rank * n_local + j``; every rank
    computes the same cut. With no pod, :func:`_windows` of the local
    mesh. Either way the shards with a lane come first."""
    if pod is None:
        return _windows(lo_i, hi_i, n_local)
    first = pod.rank * n_local
    return [(s - first, lo, hi)
            for s, lo, hi in _windows(lo_i, hi_i, pod.world * n_local)
            if first <= s < first + n_local]


def _pod_cuda_block(devices: tuple, carries: tuple, windows: list,
                    width: int, search, fold, pod) -> tuple:
    """One block of a pod rank on its CUDA mesh: ``search`` per local
    shard with a window (as :func:`_cuda_block`), its rows gathered onto
    the rank's first device (empty shards all-ones, found 0 in the until
    layout), one ``pod.gather`` of every rank's rows, then on every
    distinct local device the global rows folded into its carry."""
    n, holders = len(devices), distinct(devices)
    lead = holders[0]
    rows = {t: torch.empty((n, width), dtype=torch.int32, device=t)
            for t in holders}
    if len(windows) < n:
        rows[lead][len(windows):] = -1
        if width == 5:
            rows[lead][len(windows):, 0] = 0
    seen = set()
    for j, lo, hi in windows:
        d = devices[j]
        search(d, rows[d][j], carries[holders.index(d)], lo, hi,
               d not in seen)
        seen.add(d)
    for j, _, _ in windows:
        if devices[j] != lead:
            rows[lead][j].copy_(rows[devices[j]][j], non_blocking=True)
    everyone = pod.gather(rows[lead])
    for t, carry in zip(holders, carries):
        fold(everyone if t == lead else everyone.to(t, non_blocking=True),
             carry, t)
    return carries


def _block(devices: tuple, carries: tuple, windows: list, width: int,
           search, fold, pod) -> tuple:
    if pod is None:
        return _cuda_block(devices, carries, windows, width, search, fold)
    return _pod_cuda_block(devices, carries, windows, width, search, fold,
                           pod)


def mesh_devloop_span(midstate, template, carries: tuple, lo_i: int,
                      hi_i: int, base: int, *, rem: int, k: int, devices,
                      grid: int | None = None, peel: bool = False,
                      hoist=None, pod=None) -> tuple:
    """One block of the mesh arg-min chain over the valid lanes ``[lo_i,
    hi_i]`` (nonce = ``base + lane``): each shard's ``(hi, lo, idx)``,
    merged and folded into ``carries`` (one 5-word carry per distinct
    device, :func:`mesh_carry`). Returns the updated carries: in place on
    a CUDA mesh, without synchronising; new ones on a CPU mesh. ``grid``,
    ``peel`` and ``hoist`` as for ``ops.search.devloop_span``, per
    shard. ``pod`` (a ``parallel.multihost.Pod``): ``devices`` are this
    rank's part of the pod's global mesh; the block is cut over every
    rank's shards and every rank's rows are gathered before the folds."""
    devices = tuple(devices)
    hoist = hoist if peel else None
    windows = shard_windows(lo_i, hi_i, len(devices), pod)
    if _mesh_type(devices) == "cpu":
        rows = torch.full((len(devices), 3), M32, dtype=torch.int64)
        for j, lo, hi in windows:
            rows[j] = span_scan(midstate, template, lo, lo, hi, hi - lo + 1,
                                rem=rem, k=k, device="cpu", hoist=hoist)
        if pod is not None:
            rows = pod.gather(rows)
        return (fold_rows_argmin(carries[0], rows, base),)
    body = sha256_cuda.body_of(peel, hoist)

    def search(d, row, _carry, lo, hi, _first):
        sha256_cuda.sha256_argmin(
            midstate, template, lo, lo, hi, hi - lo + 1, rem=rem, k=k,
            device=d, grid=grid, peel=peel, hoist=hoist, out=row)

    def fold(rows, carry, d):
        sha256_cuda.mesh_fold_argmin(rows, carry, base, device=d, body=body)
    return _block(devices, carries, windows, 3, search, fold, pod)


def mesh_devloop_span_until(midstate, template, carries: tuple, lo_i: int,
                            hi_i: int, t_hi: int, t_lo: int, base: int, *,
                            rem: int, k: int, devices, span,
                            grid: int | None = None, peel: bool = False,
                            hoist=None, pod=None) -> tuple:
    """One block of the mesh difficulty chain: each shard's early-exit scan
    of its window below the target ``(t_hi, t_lo)``, merged (the lowest
    first hit and the arg-min fallback) and folded into ``carries`` (one
    8-word carry per distinct device). The block's shards share its
    lowest hit (on a CUDA mesh the words of ``span``, the span's
    :class:`MeshSpan`; None on a CPU mesh), so a shard above a stored hit
    does no lane work; once the carries say an earlier block hit, no
    shard does lane work and the carries stay as they are, so the span
    costs one fetch wherever the hit lands. Returns the updated carries
    (in place on a CUDA mesh). ``pod`` as for :func:`mesh_devloop_span`:
    no lowest-hit word crosses ranks, and the answer stays exact since
    the windows ascend with the global shard and the fold keeps the
    lowest hit."""
    devices = tuple(devices)
    hoist = hoist if peel else None
    windows = shard_windows(lo_i, hi_i, len(devices), pod)
    if _mesh_type(devices) == "cpu":
        # In a pod every rank's carry is the same (each folds every
        # rank's rows), so every rank takes this branch alike.
        if int(carries[0][0]):
            return carries
        rows = torch.tensor([[0] + [M32] * 4] * len(devices),
                            dtype=torch.int64)
        lowest = M32
        for j, lo, hi in windows:
            rows[j] = span_until_scan(
                midstate, template, lo, lo, hi, hi - lo + 1, t_hi, t_lo,
                rem=rem, k=k, device="cpu", hoist=hoist, lowest=lowest)
            lowest = int(rows[j][1])
        if pod is not None:
            rows = pod.gather(rows)
        return (fold_rows_until(carries[0], rows, base),)
    body = sha256_cuda.body_of(peel, hoist)

    def search(d, row, carry, lo, hi, first):
        sha256_cuda.sha256_until_shard(
            midstate, template, carry, lo, lo, hi, hi - lo + 1, t_hi, t_lo,
            rem=rem, k=k, device=d, hit=span.words[d], first=first,
            peers=span.hit_peers[d], grid=grid, peel=peel, hoist=hoist,
            out=row)

    def fold(rows, carry, d):
        sha256_cuda.mesh_fold_until(rows, carry, base, device=d, body=body)
    return _block(devices, carries, windows, 5, search, fold, pod)
