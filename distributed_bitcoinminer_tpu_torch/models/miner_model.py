"""The flagship model: exact SHA-256 nonce search over a nonce range.

Host orchestration around the span routers of :mod:`ops.search`, the
counterpart of the JAX package's ``models/miner_model.py``. The nonce
range is scaled by:

1. digit-class splitting (a launch hashes nonces of one decimal width);
2. aligned 10^k blocks (the top digits are constant inside a block and
   join the host midstate; the k <= 9 low digits are formatted per lane
   in uint32);
3. one kernel launch per block, chained on the device: each block's
   winner is folded into one ``ops.searchop`` carry that stays on the
   device until the span ends, so a span costs one small fetch however
   many blocks it holds.

Batched dispatch (:meth:`NonceSearcher.dispatch_batch`) serves many
argmin jobs, possibly of different messages, in one launch of the
segment-min kernel: a row per (job, 10^k block), a segment per row, and
one fetch for the whole batch (:meth:`NonceSearcher.finalize_batch`).

Difficulty mode (:meth:`NonceSearcher.search_until`) returns the FIRST
nonce whose hash is below a target, or the exact arg-min when none is:
the same chain with the early-exiting launch, whose launches after the
span's first hit do no lane work.

The peeled search (``peel=True``) runs every launch above with the peeled
lane body: K4, fed by the host hoist (``ops.sha256_torch.build_hoist``,
built once per midstate-cache entry), or K3 with ``hoist=False``.

Every launch runs under the tracing plane's launch observer
(``utils.trace.observe_launch``) with a static signature: the entry, the
kernel instantiation it reaches (the tail's variant, ``sha256_cuda.
variant_of``: a tail's ``rem`` and ``k`` are runtime arguments of one
compiled kernel, not shapes), the grid and the lane body. On the card the
first launch of a signature carries the library's load and CUDA's lazy
load of that kernel, which the observer times.

Results are bit-identical to the Go reference, ties included (the
earliest nonce wins everywhere).

Metrics (the process registry, the JAX package's families):
``model.midstate_cache{result=hit|miss}`` per block planned, and on a
miss ``model.hoist_plans{enabled}``; ``model.blocks_dispatched`` per block
planned; ``model.device_launches`` per SEARCH-kernel launch (one a block
of a chain, one a tail shape among a batched launch's rows, one a shard
window of a mesh block), so on the card its delta over a window equals
the search launches ``ops.sha256_cuda.launches`` counts in it (K1, K2,
K3, K4, and K5's search launches, without the reduces and folds; the JAX
package counts one a jitted dispatch); ``model.coalesced_launches`` and
``model.coalesced_rows`` per batched launch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..bitcoin.hash import MAX_U64, hash_op
from ..ops import searchop
from ..ops.search import (devloop_carry, devloop_span, devloop_span_until,
                          span_segmin)
from ..ops.sha256_cuda import variant_of
from ..ops.sha256_host import sha256_midstate
from ..ops.sha256_torch import M32, build_hoist, build_tail_template
from ..utils.metrics import registry as _registry
from ..utils.trace import observe_launch


# The model's process metrics (module docstring). A midstate-cache miss
# pays the host's midstate (and, for K4, hoist) build.
_M = _registry()
_MET_PLAN_HIT = _M.counter("model.midstate_cache", result="hit")
_MET_PLAN_MISS = _M.counter("model.midstate_cache", result="miss")
_MET_HOIST_ON = _M.counter("model.hoist_plans", enabled="true")
_MET_HOIST_OFF = _M.counter("model.hoist_plans", enabled="false")
_MET_BLOCKS = _M.counter("model.blocks_dispatched")
_MET_LAUNCHES = _M.counter("model.device_launches")
_MET_BATCH_LAUNCHES = _M.counter("model.coalesced_launches")
_MET_BATCH_ROWS = _M.counter("model.coalesced_rows")

#: Row cap per batched launch: a batch with more rows splits into several
#: launches (the JAX package's _BATCH_ROWS_MAX; 8 mice of 10^6 nonces are
#: 56 rows).
BATCH_ROWS_MAX = 64


def _digit_classes(lower: int, upper: int):
    """Split [lower, upper] at decimal-width boundaries (static width per
    device call). Yields (digits, lo, hi) inclusive sub-ranges."""
    for d in range(1, 21):
        class_lo = 0 if d == 1 else 10 ** (d - 1)
        class_hi = 10 ** d - 1
        lo = max(lower, class_lo)
        hi = min(upper, class_hi)
        if lo <= hi:
            yield d, lo, hi


@dataclass
class _BlockPlan:
    """One aligned 10^k block of the search, ready for device dispatch."""
    base: int          # nonce value of lane i=0 (block_base)
    lo_i: int          # first valid lane
    hi_i: int          # last valid lane
    midstate: tuple    # 8 x uint32 after absorbing data + " " + top_digits
    template: np.ndarray
    rem: int
    k: int
    #: The host hoist (ops.sha256_torch.HoistPlan) the peeled body K4
    #: reads; None when the searcher does not run K4.
    hoist: object = None

    @property
    def lanes(self) -> int:
        return self.hi_i - self.lo_i + 1

    @property
    def variant(self) -> int:
        """The search kernels' instantiation for this block's tail."""
        return variant_of(self.rem, self.k, int(self.template.shape[0]))

    @property
    def hoist_ops(self):
        """The hoist's operand dict (None without a hoist)."""
        return self.hoist.ops if self.hoist is not None else None


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA where there is none
    raises (the search never moves to the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but torch finds no "
                           "CUDA device; pass device='cpu' to search on the "
                           "CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


class NonceSearcher:
    """Exact hash search for one message, chunk-schedulable.

    ``device`` is where the lanes are hashed: ``cuda`` (the default)
    launches the CUDA kernels, ``cpu`` runs the plain PyTorch scans.
    ``grid`` overrides the kernels' block count (None: one full wave).
    ``peel`` runs every launch with the peeled lane body: K4, fed by the
    host hoist, or K3 with ``hoist=False`` (the JAX package's
    peel and hoist knobs; the plain versions on the CPU). The hoist
    is built only for the peeled body, which alone reads it.
    """

    def __init__(self, data: str, device="cuda", grid: int | None = None,
                 peel: bool = False, hoist: bool = True):
        self.data = data
        self.device = resolve_device(device)
        self.grid = grid
        self.peel = peel
        self.use_hoist = hoist
        self._prefix = data.encode("utf-8") + b" "
        self._midstate_cache: dict[tuple, tuple] = {}
        #: Searches dispatched by this searcher: one per aligned 10^k block,
        #: and one per batched launch it made for :meth:`dispatch_batch`
        #: (on ``cuda``, one kernel wrapper call each).
        self.device_launches = 0
        #: The chained launches of the last :meth:`dispatch` (one a
        #: block); a chunk's span reports them as ``subs``.
        self.last_dispatch_subs = 0

    @property
    def body(self) -> str:
        """The lane body's name: ``rolled``, ``peel`` (K3) or ``hoist``
        (K4)."""
        return ("hoist" if self.peel and self.use_hoist
                else "peel" if self.peel else "rolled")

    def _plan_block(self, d: int, k: int, block_base: int, lo: int,
                    hi: int) -> _BlockPlan:
        top = str(block_base)[: d - k] if d > k else ""
        key = (top, k)
        cached = self._midstate_cache.get(key)
        if cached is None:
            _MET_PLAN_MISS.inc()
            prefix = self._prefix + top.encode("ascii")
            midstate, tail = sha256_midstate(prefix)
            template = build_tail_template(tail, k, len(prefix) + k)
            # The hoist is part of the cache entry: built once per
            # midstate, not once per block.
            hoist = None
            if self.peel and self.use_hoist:
                hoist = build_hoist(midstate, template, len(tail), k)
            (_MET_HOIST_ON if hoist is not None else _MET_HOIST_OFF).inc()
            cached = (midstate, template, len(tail), hoist)
            self._midstate_cache[key] = cached
        else:
            _MET_PLAN_HIT.inc()
        _MET_BLOCKS.inc()
        midstate, template, rem, hoist = cached
        return _BlockPlan(
            base=block_base,
            lo_i=max(lo, block_base) - block_base,
            hi_i=min(hi, block_base + 10 ** k - 1) - block_base,
            midstate=midstate, template=template, rem=rem, k=k, hoist=hoist)

    def plan(self, lower: int, upper: int):
        """All aligned blocks covering [lower, upper], ascending."""
        for d, lo, hi in _digit_classes(lower, upper):
            k = min(d, 9)
            span = 10 ** k
            base = (lo // span) * span
            while base <= hi:
                yield self._plan_block(d, k, base, lo, hi)
                base += span

    def dispatch(self, lower: int, upper: int) -> torch.Tensor:
        """Launch every block of the range WITHOUT forcing results: one
        launch per 10^k block, each folding its winner into the span's
        5-word arg-min carry on the device. Returns the carry, the handle
        for :meth:`finalize`."""
        if lower > upper:
            raise ValueError("empty range")
        carry = devloop_carry(searchop.ARGMIN_OP, self.device)
        subs = 0
        for plan in self.plan(lower, upper):
            self.device_launches += 1
            _MET_LAUNCHES.inc()
            subs += 1
            with observe_launch(("devloop_span", plan.variant, self.grid,
                                 self.body)):
                carry = devloop_span(plan.midstate, plan.template, carry,
                                     plan.lo_i, plan.lo_i, plan.hi_i,
                                     plan.lanes, plan.base, rem=plan.rem,
                                     k=plan.k, device=self.device,
                                     grid=self.grid, peel=self.peel,
                                     hoist=plan.hoist_ops)
        self.last_dispatch_subs = subs
        return carry

    def finalize(self, carry: torch.Tensor, lower: int) -> tuple[int, int]:
        """Force a dispatched span: ONE fetch of its 20-byte carry. A span
        without a valid lane decodes to the all-ones hash at ``lower``."""
        return searchop.decode_argmin(carry.cpu(), lower)

    def search(self, lower: int, upper: int) -> tuple[int, int]:
        """Exact (min_hash, argmin_nonce) over the inclusive range."""
        return self.finalize(self.dispatch(lower, upper), lower)

    # ------------------------------------------------------ batched dispatch

    def coalesce_key(self) -> tuple:
        """Searchers with equal keys may share a batched launch (one lane
        body per launch: the peel and hoist settings are part of it)."""
        return (type(self), self.device, self.grid, self.peel,
                self.use_hoist)

    def dispatch_batch(self, entries: list):
        """Launch MANY independent argmin jobs ``[(searcher, lower,
        upper), ...]``, possibly of different messages, without forcing
        results: every job's aligned 10^k blocks become rows of the
        segment-min search (one segment per ``(job, block)``), at most
        :data:`BATCH_ROWS_MAX` rows per launch. ``self`` is the searcher
        the caller dispatches through.

        Returns the handle for :meth:`finalize_batch`, or None when the
        searchers cannot share a launch (another type, device, grid or
        lane body); that is decided before anything is launched. Raises
        on an empty range. Each answer is bit-identical to that
        searcher's own :meth:`search`."""
        key0 = self.coalesce_key()
        for s, lower, upper in entries:
            if not isinstance(s, NonceSearcher) or s.coalesce_key() != key0:
                return None
            if lower > upper:
                raise ValueError("empty range")
        rows = [(ei, plan) for ei, (s, lower, upper) in enumerate(entries)
                for plan in s.plan(lower, upper)]
        launches = [self._launch_rows(rows[at:at + BATCH_ROWS_MAX])
                    for at in range(0, len(rows), BATCH_ROWS_MAX)]
        return len(entries), [lower for _, lower, _ in entries], launches

    def _launch_rows(self, rows: list):
        """One batched launch over ``[(entry_index, plan), ...]``; segment
        ids ascend with row order. Returns ``(seg_meta, device_words)``,
        ``seg_meta[sid] = (entry_index, block base)``."""
        seg_meta, seg_ids, segs = [], {}, []
        for ei, plan in rows:
            sid = seg_ids.setdefault((ei, plan.base), len(seg_meta))
            if sid == len(seg_meta):
                seg_meta.append((ei, plan.base))
            segs.append(sid)
        self.device_launches += 1
        variants = tuple(sorted({p.variant for _, p in rows}))
        # One search launch a tail shape among the rows, then the reduce.
        _MET_LAUNCHES.inc(len(variants))
        _MET_BATCH_LAUNCHES.inc()
        _MET_BATCH_ROWS.inc(len(rows))
        with observe_launch(("span_segmin", variants, self.grid,
                             self.body)):
            words = span_segmin(
                [(p.midstate, p.template, p.lo_i, p.lo_i, p.hi_i, p.lanes,
                  p.rem, p.k, p.hoist_ops) for _, p in rows], segs,
                device=self.device, grid=self.grid, peel=self.peel)
        return seg_meta, words

    def finalize_batch(self, handle) -> list:
        """Force a batched dispatch with ONE device fetch and merge each
        job's segments on the host under the lexicographic ``(hash,
        nonce)`` minimum (the earliest nonce wins a tie). Returns one
        ``(min_hash, argmin_nonce)`` per entry, in entry order; a job
        without a valid lane answers the all-ones hash at its lower
        bound, like :meth:`finalize`."""
        n_entries, lowers, launches = handle
        cands: list[list] = [[] for _ in range(n_entries)]
        if launches:
            fetched = torch.cat([w for _, w in launches], dim=1).cpu()
            hi_w, lo_w, idx_w = fetched.tolist()
            col = 0
            for seg_meta, _ in launches:
                for ei, base in seg_meta:
                    hi, lo, idx = (hi_w[col] & M32, lo_w[col] & M32,
                                   idx_w[col] & M32)
                    col += 1
                    if (hi, lo, idx) != (M32, M32, M32):
                        cands[ei].append(((hi << 32) | lo, base + idx))
        return [min(c) if c else (MAX_U64, lowers[ei])
                for ei, c in enumerate(cands)]

    # ------------------------------------------------------ difficulty mode

    def search_until(self, lower: int, upper: int,
                     target: int) -> tuple[int, int, bool]:
        """Difficulty-target mode: (hash, nonce, found).

        Chains every block of the range, ascending, through the
        early-exiting launch and fetches the 8-word carry ONCE: a hit
        sets ``carry[0]`` on the device and every later launch sees it
        and does no lane work, so no host round trip stands between the
        blocks. Returns the first (lowest-nonce) qualifying hash, which
        the host recomputes with ``hash_op`` since the carry keeps only
        the nonce; when the whole range misses the target, returns the
        exact arg-min (found=False).
        """
        if lower > upper:
            raise ValueError("empty range")
        t_hi, t_lo = target >> 32, target & M32
        carry = devloop_carry(searchop.UNTIL_OP, self.device)
        for plan in self.plan(lower, upper):
            self.device_launches += 1
            _MET_LAUNCHES.inc()
            with observe_launch(("devloop_span_until", plan.variant,
                                 self.grid, self.body)):
                carry = devloop_span_until(
                    plan.midstate, plan.template, carry, plan.lo_i,
                    plan.lo_i, plan.hi_i, plan.lanes, t_hi, t_lo, plan.base,
                    rem=plan.rem, k=plan.k, device=self.device,
                    grid=self.grid, peel=self.peel, hoist=plan.hoist_ops)
        found, f_nonce, best_hash, best_nonce = searchop.decode_until(
            carry.cpu(), lower)
        if found:
            return hash_op(self.data, f_nonce), f_nonce, True
        return best_hash, best_nonce, False
