"""Pods: several processes join the scheduler as ONE miner.

Counterpart of the JAX package's ``parallel/multihost.py`` on
``torch.distributed`` (the north star's "a pod registers as one very wide
miner"). Every rank runs the same program; rank 0 alone owns the LSP
client. For each Request it broadcasts the job in one control frame, and
then every rank runs the same mesh search over the pod's GLOBAL mesh:
each rank's local devices, in rank order (global shard = rank x local
shards + j). Per aligned block each rank searches its own windows of
``device_windows`` cut over all the pod's shards, one ``all_gather``
carries every rank's rows to every rank, and each rank folds them all into
its own copy of the carry (the ``pod=`` argument of
``parallel.mesh_search.mesh_devloop_span``), the counterpart of the JAX
package's staged ``pmin`` over the global mesh. Every rank runs the same
host plan and makes no host decision per block, so the ranks issue the
same collectives in the same order.

Wiring:

- :func:`initialize_multihost` joins the process group (a TCP rendezvous
  at ``DBMT_COORDINATOR``, ``DBMT_NUM_PROCS`` ranks, this one
  ``DBMT_PROC_ID``); unset, the miner stays a plain single-process miner;
- the miner's followers (:func:`is_lsp_owner` false) never touch LSP: they
  run :func:`run_follower` and exit 0 on the stop frame;
- the owner's searcher factory builds :class:`PodSearcher`, which
  broadcasts the job and runs the shared search; the owner broadcasts the
  stop frame on every exit path.

Two process groups. The control frames travel on the default group, a
``gloo`` group whose timeout (a year) leaves an idle pool's wait between
jobs bounded only by ``DBMT_POD_IDLE_TIMEOUT_S``. The rows travel on a
group chosen from the layout at start-up (:func:`row_backend`): every rank
reports its cards' UUIDs over the control group; if every rank's cards are
distinct, ``nccl`` (the gather runs on the cards' streams with no host
synchronisation); if a card is shared between ranks (NCCL refuses two
ranks on one card) or the mesh is on the CPU, ``gloo``, which takes the
rows through host memory (one synchronisation a block). The choice is
logged once; an NCCL group that fails to start raises (no fallback).

Failure domain (:func:`bounded_pod_call`): a peer that dies mid-job makes
a gloo collective raise (where XLA's collectives wedge) or an NCCL one
hang; both end the process with exit code 17 (a raise at once, a hang
after ``DBMT_POD_TIMEOUT_S``). On the owner that drops its LSP connection,
so the scheduler drops the pod miner and gives its chunk to another. A
deterministic compute error still raises on every rank alike, as in the
JAX package: the owner's miner leaves the pool, and a follower logs it and
waits for the next frame.

Departure: in difficulty mode a rank's shards share its cards' lowest-hit
words (``MeshSpan``), but no word crosses ranks, so a rank whose windows
lie above another rank's first hit still scans them. The answer stays
exact: the windows ascend with the global shard, and the fold keeps the
lowest hit (:attr:`~..models.sharded.MeshNonceSearcher.hit_scope` says
``"rank"``).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import OrderedDict
from datetime import timedelta
from typing import Optional

import torch

from ..ops import sha256_cuda
from ..utils.config import PeelParams, PodParams, pod_from_env

logger = logging.getLogger("dbmt.multihost")

#: The control frame (int64 words; torch on the CPU has no uint32
#: arithmetic), the JAX package's layout word for word: [opcode, data_len,
#: lo_hi, lo_lo, up_hi, up_lo, t_hi, t_lo, data bytes...]. Opcode 0 stops
#: the pod, 1 is an arg-min job (target words 0), 2 a difficulty job; 3
#: (the port's own) restarts the followers' launch counters.
_MAX_DATA = 992
_FRAME = 8 + _MAX_DATA
OP_STOP, OP_ARGMIN, OP_UNTIL, OP_RESET = 0, 1, 2, 3
#: Exit code of a rank whose pod job (or idle wait) outlived its bound, or
#: whose collective failed because a peer died.
POD_EXIT = 17
#: The control group's timeout: long enough that only
#: ``DBMT_POD_IDLE_TIMEOUT_S`` bounds an idle follower's wait.
CONTROL_TIMEOUT = timedelta(days=365)

_M32 = 0xFFFFFFFF


class PodPeerError(RuntimeError):
    """A collective of the pod failed: a peer died or left."""


def _collective(fn, *args, **kw):
    """Run one collective; any failure of it is a :class:`PodPeerError`."""
    try:
        return fn(*args, **kw)
    except Exception as exc:   # noqa: BLE001 — re-raised as the pod's
        raise PodPeerError(f"pod collective failed: {exc}") from exc


def device_uuids(devices) -> list:
    """Each local device's identity for the layout exchange: the card's
    UUID, or ``"cpu"``."""
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cpu":
            out.append("cpu")
        else:
            index = d.index if d.index is not None \
                else torch.cuda.current_device()
            out.append(str(torch.cuda.get_device_properties(index).uuid))
    return out


def row_backend(uuids_by_rank: list) -> tuple:
    """The row exchange's backend from every rank's device identities
    (:func:`device_uuids`, in rank order): ``("gloo", why)`` when a mesh is
    on the CPU or a card appears under more than one rank, else
    ``("nccl", why)``. A card that repeats within one rank's mesh (several
    shards of one card) is not shared between ranks."""
    if any("cpu" in ids for ids in uuids_by_rank):
        return "gloo", "a CPU mesh"
    per_rank = [set(ids) for ids in uuids_by_rank]
    if sum(len(s) for s in per_rank) != len(set().union(*per_rank)):
        return "gloo", "a card shared between ranks"
    return "nccl", "every rank's cards distinct"


class Pod:
    """This process's place in the pod: ``rank`` of ``world``, its local
    mesh ``devices`` (a tuple of ``torch.device``), the row exchange's
    ``backend`` and its group, and ``gathers``, the row gathers made so
    far (one a block)."""

    def __init__(self, params: PodParams, devices: tuple, backend: str,
                 rows_group=None):
        self.params = params
        self.rank, self.world = params.proc_id, params.num_procs
        self.devices = devices
        self.backend = backend
        self.rows_group = rows_group
        self.gathers = 0

    @property
    def n_local(self) -> int:
        return len(self.devices)

    def gather(self, rows: torch.Tensor) -> torch.Tensor:
        """Every rank's ``(n_local, width)`` rows, stacked in rank order
        into ``(world * n_local, width)`` on ``rows``' device. Over NCCL
        the gather is ordered on the card's current stream; over gloo the
        rows cross the host (on a card: one synchronisation)."""
        import torch.distributed as dist
        self.gathers += 1
        if self.backend == "nccl":
            out = torch.empty((self.world * rows.shape[0], rows.shape[1]),
                              dtype=rows.dtype, device=rows.device)
            with torch.cuda.device(rows.device):
                _collective(dist.all_gather_into_tensor, out,
                            rows.contiguous(), group=self.rows_group)
            return out
        host = rows.cpu()
        parts = [torch.empty_like(host) for _ in range(self.world)]
        _collective(dist.all_gather, parts, host, group=self.rows_group)
        out = torch.cat(parts)
        return out if rows.device.type == "cpu" else out.to(rows.device)


_pod: Optional[Pod] = None


def active_pod() -> Optional[Pod]:
    """This process's pod, or None outside one."""
    return _pod


def initialize_multihost(devices, params: Optional[PodParams] = None
                         ) -> Optional[Pod]:
    """Join the pod and return it, or None when ``params`` (default: the
    environment's, :func:`~..utils.config.pod_from_env`) names no
    coordinator. ``devices``: this rank's local mesh (device names or
    ``torch.device``s). Every rank must bring as many devices. Chooses
    the row exchange's backend (:func:`row_backend`), logs it, and on
    ``nccl`` starts the group with one gather, so that a failed NCCL start
    raises here."""
    global _pod
    params = params if params is not None else pod_from_env()
    if params.coordinator is None:
        return None
    import torch.distributed as dist

    from .mesh_search import make_mesh
    devices = make_mesh(devices=devices)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{params.coordinator}",
        world_size=params.num_procs, rank=params.proc_id,
        timeout=CONTROL_TIMEOUT)
    uuids: list = [None] * params.num_procs
    dist.all_gather_object(uuids, device_uuids(devices))
    if len({len(ids) for ids in uuids}) != 1:
        raise ValueError(f"every rank of a pod needs as many devices: "
                         f"{[len(ids) for ids in uuids]}")
    backend, why = row_backend(uuids)
    rows_group = None
    if backend == "nccl":
        torch.cuda.set_device(devices[0])
        rows_group = dist.new_group(
            backend="nccl", timeout=timedelta(
                seconds=2 * max(params.timeout_s, 60.0)))
    _pod = Pod(params, devices, backend, rows_group)
    if backend == "nccl":
        _pod.gather(torch.zeros((1, 1), dtype=torch.int32,
                                device=devices[0]))
        torch.cuda.synchronize(devices[0])
        _pod.gathers = 0
    logger.info("pod: rank %d/%d, %d local shard(s) on %s, %d global; "
                "rows over %s (%s)", params.proc_id, params.num_procs,
                len(devices), ",".join(str(d) for d in devices),
                params.num_procs * len(devices), backend, why)
    return _pod


def shutdown() -> None:
    """Leave the pod: destroy its process groups (a failure to, once a
    peer is gone, is logged)."""
    global _pod
    if _pod is None:
        return
    _pod = None
    import torch.distributed as dist
    try:
        dist.destroy_process_group()
    except Exception:   # noqa: BLE001 — leaving anyway
        logger.exception("pod: destroying the process groups failed")


def _require_pod() -> Pod:
    if _pod is None:
        raise RuntimeError("no pod: initialize_multihost has not joined one")
    return _pod


def is_lsp_owner() -> bool:
    """True on the rank that speaks LSP for the whole pod (rank 0), and
    outside a pod."""
    return _pod is None or _pod.rank == 0


def _exit_pod(why: str) -> None:
    logger.error("%s; exiting (%d) so this rank leaves the pool and its "
                 "chunk runs elsewhere", why, POD_EXIT)
    logging.shutdown()
    os._exit(POD_EXIT)


def bounded_pod_call(fn, timeout_s: Optional[float] = None):
    """Run one pod job under the failure-domain bound: ``fn`` runs in a
    daemon thread; if a collective of it fails (:class:`PodPeerError`: a
    peer died) or it outlives ``timeout_s`` (default the pod's
    ``DBMT_POD_TIMEOUT_S``; a hung collective cannot be cancelled from
    Python), the process exits with code 17. Any other exception (a
    deterministic compute error, raised on every rank alike) is re-raised
    here."""
    outcome: list = []

    def target():
        try:
            outcome.append(("ok", fn()))
        except PodPeerError as exc:
            outcome.append(("peer", exc))
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            outcome.append(("err", exc))

    if timeout_s is None:
        timeout_s = (_pod.params if _pod is not None
                     else pod_from_env()).timeout_s
    worker = threading.Thread(target=target, daemon=True)
    worker.start()
    worker.join(timeout_s)
    if not outcome:
        _exit_pod(f"a pod job outlived its bound of {timeout_s:.0f} s (a "
                  "peer likely died inside a collective)")
    kind, value = outcome[0]
    if kind == "peer":
        _exit_pod(f"a pod collective failed ({value})")
    if kind == "err":
        raise value
    return value


def _broadcast_frame(frame: Optional[torch.Tensor]) -> torch.Tensor:
    """One pod-wide control broadcast over the control group; rank 0
    supplies the frame."""
    import torch.distributed as dist
    if frame is None:
        frame = torch.zeros(_FRAME, dtype=torch.int64)
    _collective(dist.broadcast, frame, 0)
    return frame


def job_frame(op: int, data: str = "", lower: int = 0, upper: int = 0,
              target: int = 0) -> torch.Tensor:
    """The control frame of one opcode (the JAX package's layout)."""
    raw = data.encode("utf-8")
    if len(raw) > _MAX_DATA:
        raise ValueError(f"message too long for pod broadcast: {len(raw)}")
    frame = torch.zeros(_FRAME, dtype=torch.int64)
    frame[:8] = torch.tensor([op, len(raw), lower >> 32, lower & _M32,
                              upper >> 32, upper & _M32, target >> 32,
                              target & _M32], dtype=torch.int64)
    if raw:
        frame[8:8 + len(raw)] = torch.tensor(list(raw), dtype=torch.int64)
    return frame


def broadcast_job(data: str, lower: int, upper: int,
                  target: int = 0) -> None:
    """Rank 0: announce one search job to every follower (opcode 2 when
    ``target`` is nonzero, else 1)."""
    _broadcast_frame(job_frame(OP_UNTIL if target else OP_ARGMIN, data,
                               lower, upper, target))


def broadcast_stop() -> None:
    """Rank 0: release every follower (pod shutdown)."""
    _broadcast_frame(job_frame(OP_STOP))


def broadcast_reset() -> None:
    """Rank 0: the followers restart their launch counters at 0 (after
    the rate probe, which they ran too)."""
    _broadcast_frame(job_frame(OP_RESET))


def _receive_job():
    """Follower: block for the next control frame. Returns None on stop,
    ``"reset"`` on the counters' reset, else ``(data, lower, upper,
    target)`` (target 0: an arg-min job)."""
    frame = _broadcast_frame(None).tolist()
    op = frame[0]
    if op == OP_STOP:
        return None
    if op == OP_RESET:
        return "reset"
    data = bytes(frame[8:8 + frame[1]]).decode("utf-8")
    lower = (frame[2] << 32) | frame[3]
    upper = (frame[4] << 32) | frame[5]
    target = (frame[6] << 32) | frame[7] if op == OP_UNTIL else 0
    return data, lower, upper, target


def pod_mesh_searcher(data: str, body: PeelParams = PeelParams()):
    """The pod's per-rank program for ``data``: the mesh searcher over
    this rank's devices, joined to the pod. Owner and followers build the
    same one (the lane body from each rank's ``DBMT_PEEL``/``DBMT_HOIST``,
    which a deployment exports alike)."""
    from ..models import MeshNonceSearcher
    pod = _require_pod()
    return MeshNonceSearcher(data, devices=pod.devices, peel=body.peel,
                             hoist=body.hoist, pod=pod)


class PodSearcher:
    """Owner-side searcher: broadcast the job, then run the global-mesh
    search that every rank runs in lockstep. Only ``search`` and
    ``search_until``, as in the JAX package (the miner serves it through
    its blocking path)."""

    def __init__(self, data: str, body: PeelParams = PeelParams()):
        self.data = data
        self.inner = pod_mesh_searcher(data, body)

    def search(self, lower: int, upper: int):
        return bounded_pod_call(lambda: (
            broadcast_job(self.data, lower, upper),
            self.inner.search(lower, upper))[1])

    def search_until(self, lower: int, upper: int, target: int):
        if not target:
            # Target 0 would go out as an arg-min frame while the owner
            # ran the until chain; 0 never qualifies, so the arg-min with
            # found False is the same answer.
            return (*self.search(lower, upper), False)
        return bounded_pod_call(lambda: (
            broadcast_job(self.data, lower, upper, target),
            self.inner.search_until(lower, upper, target))[1])


def follower_counts() -> dict:
    """A follower's kernel launches and row gathers so far."""
    pod = _require_pod()
    return {"kernel_launches": dict(sha256_cuda.launches),
            "row_gathers": pod.gathers}


def run_follower(body: PeelParams = PeelParams(),
                 cache_size: Optional[int] = None) -> int:
    """Follower main loop: run broadcast jobs until the stop frame; returns
    the jobs run. Keeps the owner's searcher cache (one per message, the
    miner's ``SEARCHER_CACHE_SIZE``, LRU). Each job logs ``follower job``
    at its start and ``follower counts`` (its launches and row gathers so
    far) at its end. The wait between jobs is bounded by
    ``DBMT_POD_IDLE_TIMEOUT_S`` when it is positive; an owner that dies
    while the follower waits ends the follower (exit 17) either way."""
    from ..apps.miner import MinerWorker
    pod = _require_pod()
    if cache_size is None:
        cache_size = MinerWorker.SEARCHER_CACHE_SIZE
    searchers: OrderedDict = OrderedDict()
    idle = pod.params.idle_timeout_s
    jobs = 0
    while True:
        if idle > 0:
            job = bounded_pod_call(_receive_job, timeout_s=idle)
        else:
            try:
                job = _receive_job()
            except PodPeerError as exc:
                _exit_pod(f"the owner left between jobs ({exc})")
        if job is None:
            return jobs
        if job == "reset":
            sha256_cuda.reset_launches()
            pod.gathers = 0
            continue
        data, lower, upper, target = job
        s = searchers.get(data)
        if s is None:
            s = searchers[data] = pod_mesh_searcher(data, body)
            while len(searchers) > cache_size:
                searchers.popitem(last=False)
        else:
            searchers.move_to_end(data)
        logger.info("follower job %d: %r [%d, %d] target=%d", jobs + 1,
                    data, lower, upper, target)
        t0 = time.monotonic()
        try:
            if target:
                bounded_pod_call(lambda: s.search_until(lower, upper,
                                                        target))
            else:
                bounded_pod_call(lambda: s.search(lower, upper))
        except Exception:
            # The same compute error raised on the owner, whose miner
            # leaves the pool and stops the pod; keep waiting for its
            # frame.
            logger.exception("follower search failed for %r [%d, %d]",
                             data, lower, upper)
        jobs += 1
        logger.info("follower done in %.3fs; follower counts %s",
                    time.monotonic() - t0, json.dumps(follower_counts()))
