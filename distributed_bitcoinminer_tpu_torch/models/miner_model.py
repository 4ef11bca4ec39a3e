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

Difficulty mode (:meth:`NonceSearcher.search_until`) returns the FIRST
nonce whose hash is below a target, or the exact arg-min when none is:
the same chain with the early-exiting launch, whose launches after the
span's first hit do no lane work.

Results are bit-identical to the Go reference, ties included (the
earliest nonce wins everywhere).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..bitcoin.hash import hash_op
from ..ops import searchop
from ..ops.search import devloop_carry, devloop_span, devloop_span_until
from ..ops.sha256_host import sha256_midstate
from ..ops.sha256_torch import M32, build_tail_template


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

    @property
    def lanes(self) -> int:
        return self.hi_i - self.lo_i + 1


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
    """

    def __init__(self, data: str, device="cuda", grid: int | None = None):
        self.data = data
        self.device = resolve_device(device)
        self.grid = grid
        self._prefix = data.encode("utf-8") + b" "
        self._midstate_cache: dict[tuple, tuple] = {}
        #: Block searches dispatched by this searcher: one per aligned 10^k
        #: block (on ``cuda``, one kernel wrapper call).
        self.device_launches = 0

    def _plan_block(self, d: int, k: int, block_base: int, lo: int,
                    hi: int) -> _BlockPlan:
        top = str(block_base)[: d - k] if d > k else ""
        key = (top, k)
        cached = self._midstate_cache.get(key)
        if cached is None:
            prefix = self._prefix + top.encode("ascii")
            midstate, tail = sha256_midstate(prefix)
            template = build_tail_template(tail, k, len(prefix) + k)
            cached = (midstate, template, len(tail))
            self._midstate_cache[key] = cached
        midstate, template, rem = cached
        return _BlockPlan(
            base=block_base,
            lo_i=max(lo, block_base) - block_base,
            hi_i=min(hi, block_base + 10 ** k - 1) - block_base,
            midstate=midstate, template=template, rem=rem, k=k)

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
        for plan in self.plan(lower, upper):
            self.device_launches += 1
            carry = devloop_span(plan.midstate, plan.template, carry,
                                 plan.lo_i, plan.lo_i, plan.hi_i, plan.lanes,
                                 plan.base, rem=plan.rem, k=plan.k,
                                 device=self.device, grid=self.grid)
        return carry

    def finalize(self, carry: torch.Tensor, lower: int) -> tuple[int, int]:
        """Force a dispatched span: ONE fetch of its 20-byte carry. A span
        without a valid lane decodes to the all-ones hash at ``lower``."""
        return searchop.decode_argmin(carry.cpu(), lower)

    def search(self, lower: int, upper: int) -> tuple[int, int]:
        """Exact (min_hash, argmin_nonce) over the inclusive range."""
        return self.finalize(self.dispatch(lower, upper), lower)

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
            carry = devloop_span_until(
                plan.midstate, plan.template, carry, plan.lo_i, plan.lo_i,
                plan.hi_i, plan.lanes, t_hi, t_lo, plan.base, rem=plan.rem,
                k=plan.k, device=self.device, grid=self.grid)
        found, f_nonce, best_hash, best_nonce = searchop.decode_until(
            carry.cpu(), lower)
        if found:
            return hash_op(self.data, f_nonce), f_nonce, True
        return best_hash, best_nonce, False
