"""The mesh searcher: one miner over several devices.

Counterpart of the JAX package's ``models/sharded.py::MeshNonceSearcher``
on its devloop shape (the north star's "a pod registers as one very wide
miner"): each aligned 10^k block of a span is cut into one contiguous
window per shard of the mesh, every shard searches its window, and the
shards' results are merged and folded into the span's carry on the
devices (``parallel.mesh_search``), which crosses the host once per span.
The plan, the midstate cache, the lane bodies (``peel``, ``hoist``) and
the batched dispatch are :class:`NonceSearcher`'s: coalesced mice ride the
segment-min launch on the mesh's first device, as in the JAX package.
Each block's shard searches and folds run under one launch-observer
signature (``utils.trace.observe_launch``). In
difficulty mode the shards of a block share its lowest hit
(``parallel.mesh_search.MeshSpan``), across cards through peer memory
where every pair of cards has it (:attr:`MeshNonceSearcher.hit_scope`).
Joined to a pod (``pod=``, ``parallel.multihost``), the searcher is one
rank's part of the pod's global mesh: each block is cut over every
rank's shards, and the rows of all ranks are gathered before each
rank's folds (the ``pod=`` argument of
``parallel.mesh_search.mesh_devloop_span``).
"""

from __future__ import annotations

from ..bitcoin.hash import hash_op
from ..ops import searchop
from ..ops.sha256_torch import M32
from ..parallel.mesh_search import (MeshSpan, hit_scope, make_mesh,
                                    mesh_carry, mesh_devloop_span,
                                    mesh_devloop_span_until, shard_windows)
from ..utils.trace import observe_launch
from .miner_model import _MET_LAUNCHES, NonceSearcher


class MeshNonceSearcher(NonceSearcher):
    """Exact hash search for one message over a mesh of devices.

    ``devices``: the mesh, one entry per shard (default every visible CUDA
    device; ``parallel.mesh_search.make_mesh``). An entry may repeat: four
    shards on one card run one after another on its stream. A CPU mesh
    (``["cpu"] * n``) runs the plain scans, merge and folds. ``grid``
    overrides each shard launch's block count; ``peel`` and ``hoist`` pick
    the lane body as for :class:`NonceSearcher`. ``pod`` (a
    ``parallel.multihost.Pod``) joins the searcher to a pod: ``devices``
    are then this rank's part of the pod's global mesh, and every rank
    must run the same calls in the same order.
    """

    def __init__(self, data: str, devices=None, grid: int | None = None,
                 peel: bool = False, hoist: bool = True, pod=None):
        self.devices = make_mesh(devices=devices)
        super().__init__(data, device=self.devices[0], grid=grid, peel=peel,
                         hoist=hoist)
        self.n_devices = len(self.devices)
        self.pod = pod
        self._local_scope = hit_scope(self.devices)
        self._hit_scope = self._local_scope
        if pod is not None and pod.world > 1:
            self._hit_scope = "rank" if self._local_scope == "mesh" \
                else "card"

    @property
    def hit_scope(self) -> str:
        """``"mesh"`` when a difficulty block's shards all share its
        lowest hit (one card, a CPU mesh, or cards with peer access
        between every pair); ``"card"`` when only each card's shards do;
        in a pod of several ranks ``"rank"`` when each rank's shards share
        theirs (no hit crosses ranks). Fixed at construction."""
        return self._hit_scope

    def _chain(self, lower: int, upper: int, target: int | None = None):
        """Every block of ``[lower, upper]`` through the mesh's arg-min
        chain, or with a ``target`` its difficulty chain; returns the
        first device's carry (unforced)."""
        op = searchop.ARGMIN_OP if target is None else searchop.UNTIL_OP
        carries = mesh_carry(op, self.devices)
        span = None
        if target is not None and self.devices[0].type == "cuda":
            span = MeshSpan(self.devices, self._local_scope, self.body)
        entry = "mesh_devloop_span" if target is None \
            else "mesh_devloop_until"
        if self.pod is not None:
            entry = "pod_" + entry
        subs = 0
        for plan in self.plan(lower, upper):
            self.device_launches += 1
            # One search launch a shard of this rank with lanes to scan.
            _MET_LAUNCHES.inc(len(shard_windows(plan.lo_i, plan.hi_i,
                                                self.n_devices, self.pod)))
            subs += 1
            kw = dict(rem=plan.rem, k=plan.k, devices=self.devices,
                      grid=self.grid, peel=self.peel, hoist=plan.hoist_ops)
            with observe_launch((entry, plan.variant, self.grid, self.body,
                                 self.n_devices)):
                if target is None:
                    carries = mesh_devloop_span(
                        plan.midstate, plan.template, carries, plan.lo_i,
                        plan.hi_i, plan.base, pod=self.pod, **kw)
                else:
                    carries = mesh_devloop_span_until(
                        plan.midstate, plan.template, carries, plan.lo_i,
                        plan.hi_i, target >> 32, target & M32, plan.base,
                        span=span, pod=self.pod, **kw)
        if target is None:
            self.last_dispatch_subs = subs
        return carries[0]

    def dispatch(self, lower: int, upper: int):
        """Launch every block of the range over the mesh WITHOUT forcing
        results: per block, one search per shard with a window and one
        mesh fold per distinct device into the span's 5-word carry.
        Returns the first device's carry, the handle for
        :meth:`finalize` (one 20-byte fetch)."""
        if lower > upper:
            raise ValueError("empty range")
        return self._chain(lower, upper)

    def search_until(self, lower: int, upper: int,
                     target: int) -> tuple[int, int, bool]:
        """Difficulty mode over the mesh: (hash, nonce, found), with ONE
        fetch of the 8-word carry per span; after the span's first hit
        every later shard launch does no lane work. The first qualifying
        nonce is the lowest over the shards of the hit block, and its hash
        is recomputed on the host."""
        if lower > upper:
            raise ValueError("empty range")
        found, f_nonce, best_hash, best_nonce = searchop.decode_until(
            self._chain(lower, upper, target).cpu(),
            lower)
        if found:
            return hash_op(self.data, f_nonce), f_nonce, True
        return best_hash, best_nonce, False

    def coalesce_key(self) -> tuple:
        """Mesh searchers share a batched launch only with mesh searchers
        of the same devices and lane body."""
        return (type(self), self.devices, self.grid, self.peel,
                self.use_hoist)
