"""Span scans over one aligned 10^k block: arg-min, difficulty target, and
the device-resident chain.

Counterpart of the JAX package's ``ops/search.py``:

- :func:`span_scan` / :func:`span_argmin` (``search_span``): the lanes
  ``i0 + [0, n)``, masked to ``[lo_i, hi_i]``, reduce to the lexicographic
  ``(hash_hi, hash_lo, index)`` minimum; a span without a valid lane
  returns the all-ones sentinel.
- :func:`span_until_scan` / :func:`span_until` (``search_span_until``):
  the same lanes walked in ascending order up to the first one whose hash
  is below a 64-bit target; ``(found, f_idx, best_hi, best_lo,
  best_idx)``.
- :func:`span_segmin_scan` / :func:`span_segmin` (``search_span_segmin``):
  many rows, each a :func:`span_scan` over its own plan (rows may hold
  different messages, digit classes and lane counts), reduced to the
  lexicographic minimum per segment (:func:`segmin_rows`), for batched
  dispatch across requests.
- :func:`devloop_span` / :func:`devloop_span_until` (``devloop_span`` /
  ``devloop_span_until``): one block of a span's chain, its result folded
  into an ``ops.searchop`` carry that stays on the device until the span
  ends.

Each router launches the hand-written kernel (``ops.sha256_cuda``) on a
CUDA device or raises; on the CPU it runs the plain PyTorch version. Any
other device raises. Every router takes ``peel`` and ``hoist`` (a
``HoistPlan.ops`` dict or None) and passes ``hoist if peel else None`` on,
as the JAX package's Pallas wrappers do: on a CUDA device ``peel`` runs
the peeled body, K3, or with the hoist K4; on the CPU the hoisted plain
compression runs when a hoist gets through, the full one otherwise (K3
computes K1's function from K1's operands, so its plain version is the
plain scan itself).
"""

from __future__ import annotations

import torch

from . import searchop, sha256_cuda
from .sha256_torch import M32, hash_lanes, lex_argmin

#: Default lanes per step of the plain scans, by device type.
PLAIN_CHUNK = {"cpu": 1 << 14, "cuda": 1 << 22}


def _device_chunk(device, chunk):
    device = torch.device(device)
    return device, chunk or PLAIN_CHUNK.get(device.type, 1 << 14)


def _chunk_best(midstate, template, i, lo_i: int, hi_i: int, rem: int,
                k: int, best: torch.Tensor, hoist=None):
    """Hash the lane vector ``i`` (through the hoisted compression when
    ``hoist`` is given), fold its lexicographic minimum into ``best``
    with a strict less on the full key (an earlier chunk keeps a tie,
    the Go scan's first-seen-wins); returns (best, hi, lo, valid)."""
    hi, lo = hash_lanes(midstate, template, i, rem, k, hoist=hoist)
    valid = (i >= lo_i) & (i <= hi_i)
    cand = torch.stack(lex_argmin(torch.where(valid, hi, M32),
                                  torch.where(valid, lo, M32),
                                  torch.where(valid, i, M32)))
    better = ((cand[0] < best[0])
              | ((cand[0] == best[0])
                 & ((cand[1] < best[1])
                    | ((cand[1] == best[1]) & (cand[2] < best[2])))))
    return torch.where(better, cand, best), hi, lo, valid


def span_scan(midstate, template, i0: int, lo_i: int, hi_i: int, n: int, *,
              rem: int, k: int, device, chunk: int | None = None,
              hoist=None) -> torch.Tensor:
    """Plain chunked scan: returns a (3,) int64 tensor on ``device``
    holding ``(hi, lo, idx)``. Steps of ``chunk`` lanes run in ascending
    order; with ``hoist`` each lane takes the hoisted compression (K4's
    plain version)."""
    device, chunk = _device_chunk(device, chunk)
    best = torch.full((3,), M32, dtype=torch.int64, device=device)
    lane = torch.arange(min(chunk, n), dtype=torch.int64, device=device)
    for start in range(0, n, chunk):
        i = lane[:min(chunk, n - start)] + (i0 + start)
        best = _chunk_best(midstate, template, i, lo_i, hi_i, rem, k,
                           best, hoist)[0]
    return best


def span_until_scan(midstate, template, i0: int, lo_i: int, hi_i: int,
                    n: int, t_hi: int, t_lo: int, *, rem: int, k: int,
                    device, chunk: int | None = None, hoist=None,
                    lowest: int = M32) -> torch.Tensor:
    """Plain chunked difficulty scan: returns a (5,) int64 tensor on
    ``device`` holding ``(found, f_idx, best_hi, best_lo, best_idx)``.

    Steps of ``chunk`` lanes run in ascending order and stop after the
    first step that holds a valid lane whose hash is below the target
    ``(t_hi, t_lo)``; ``f_idx`` is the lowest such lane (all-ones when
    none). ``best_*`` is the arg-min over the steps that ran, so it is
    the span's arg-min when ``found`` is 0 and is meaningful only then.
    ``hoist``: as for :func:`span_scan`. ``lowest``: the lowest hit of
    the block so far, a qualifying lane in the same lane coordinates
    (all-ones: none; the plain version of the lowest-hit word a mesh's
    until shards share): no lane above it is scanned, and ``f_idx`` is
    at most it.
    """
    device, chunk = _device_chunk(device, chunk)
    best = torch.full((3,), M32, dtype=torch.int64, device=device)
    f_idx = torch.tensor(M32, dtype=torch.int64, device=device)
    hi_i = min(hi_i, lowest)
    n = max(0, min(n, hi_i - i0 + 1))
    lane = torch.arange(min(chunk, n), dtype=torch.int64, device=device)
    for start in range(0, n, chunk):
        i = lane[:min(chunk, n - start)] + (i0 + start)
        best, hi, lo, valid = _chunk_best(midstate, template, i, lo_i, hi_i,
                                          rem, k, best, hoist)
        qual = valid & ((hi < t_hi) | ((hi == t_hi) & (lo < t_lo)))
        f_idx = torch.where(qual, i, M32).min()
        if int(f_idx) != M32:
            break
    f_idx = torch.clamp(f_idx, max=lowest)
    found = (f_idx != M32).to(torch.int64)
    return torch.cat([torch.stack([found, f_idx]), best])


def span_argmin(midstate, template, i0: int, lo_i: int, hi_i: int, n: int,
                *, rem: int, k: int, device, grid: int | None = None,
                peel: bool = False, hoist=None) -> torch.Tensor:
    """The span's ``(hi, lo, idx)`` as a (3,) tensor on ``device`` (int32
    words from the kernel, int64 from the plain scan; mask with
    ``& 0xFFFFFFFF`` on the host). Does not synchronise."""
    device = torch.device(device)
    hoist = hoist if peel else None
    if device.type == "cuda":
        return sha256_cuda.sha256_argmin(midstate, template, i0, lo_i, hi_i,
                                         n, rem=rem, k=k, device=device,
                                         grid=grid, peel=peel, hoist=hoist)
    if device.type == "cpu":
        return span_scan(midstate, template, i0, lo_i, hi_i, n,
                         rem=rem, k=k, device=device, hoist=hoist)
    raise ValueError(f"no span scan for device {device}")


def span_until(midstate, template, i0: int, lo_i: int, hi_i: int, n: int,
               t_hi: int, t_lo: int, *, rem: int, k: int, device,
               grid: int | None = None, peel: bool = False,
               hoist=None) -> torch.Tensor:
    """The span's ``(found, f_idx, best_hi, best_lo, best_idx)`` as a (5,)
    tensor on ``device`` (int32 words from K2, int64 from the plain scan).
    Does not synchronise on a CUDA device."""
    device = torch.device(device)
    hoist = hoist if peel else None
    if device.type == "cuda":
        return sha256_cuda.sha256_until(midstate, template, i0, lo_i, hi_i,
                                        n, t_hi, t_lo, rem=rem, k=k,
                                        device=device, grid=grid, peel=peel,
                                        hoist=hoist)
    if device.type == "cpu":
        return span_until_scan(midstate, template, i0, lo_i, hi_i, n,
                               t_hi, t_lo, rem=rem, k=k, device=device,
                               hoist=hoist)
    raise ValueError(f"no span scan for device {device}")


def segmin_rows(hi: torch.Tensor, lo: torch.Tensor, idx: torch.Tensor,
                seg, num_segments: int):
    """Per-segment lexicographic ``(hi, lo, idx)`` minimum over row
    vectors (int64 words, masked to 32 bits); ``seg`` maps each row to
    its segment, ascending. Three passes: min hi, then min lo among the
    hi-ties, then min idx among the (hi, lo)-ties, so the lowest nonce
    wins a tie, and a segment without a row, or whose rows are all the
    sentinel, comes out as ``(MAX, MAX, MAX)``. Returns
    ``(seg_hi, seg_lo, seg_idx)``, each of ``num_segments`` words."""
    seg = torch.as_tensor(seg, dtype=torch.int64, device=hi.device)
    full = torch.full((num_segments,), M32, dtype=torch.int64,
                      device=hi.device)

    def seg_min(v):
        return full.scatter_reduce(0, seg, v, reduce="amin")
    seg_hi = seg_min(hi)
    on_hi = hi == seg_hi[seg]
    seg_lo = seg_min(torch.where(on_hi, lo, M32))
    on_both = on_hi & (lo == seg_lo[seg])
    seg_idx = seg_min(torch.where(on_both, idx, M32))
    return seg_hi, seg_lo, seg_idx


def span_segmin_scan(rows, seg, num_segments: int | None = None, *,
                     device, chunk: int | None = None) -> torch.Tensor:
    """Plain version of K5: each row ``(midstate, template, i0, lo_i,
    hi_i, n, rem, k[, hoist])`` through :func:`span_scan` (hoisted when
    the row carries a hoist), then :func:`segmin_rows` over ``seg``
    (default ``seg[-1] + 1`` segments). Returns a (3, S) int64 tensor on
    ``device``: seg_hi, seg_lo, seg_idx."""
    seg = [int(x) for x in seg]
    num_segments = seg[-1] + 1 if num_segments is None else num_segments
    triples = torch.stack([
        span_scan(*row[:6], rem=row[6], k=row[7], device=device,
                  chunk=chunk, hoist=row[8] if len(row) > 8 else None)
        for row in rows])
    return torch.stack(segmin_rows(triples[:, 0], triples[:, 1],
                                   triples[:, 2], seg, num_segments))


def span_segmin(rows, seg, *, device, grid: int | None = None,
                peel: bool = False) -> torch.Tensor:
    """The rows' per-segment ``(seg_hi, seg_lo, seg_idx)`` as a (3, S)
    tensor on ``device`` (int32 words from K5, int64 from the plain scan;
    mask with ``& 0xFFFFFFFF`` on the host). A row may carry its hoist as
    a ninth element; it reaches the kernel or the plain scan only with
    ``peel``. Does not synchronise."""
    device = torch.device(device)
    rows = [tuple(r[:8]) + ((r[8],) if peel and len(r) > 8 else ())
            for r in rows]
    if device.type == "cuda":
        return sha256_cuda.sha256_segmin(rows, seg, device=device, grid=grid,
                                         peel=peel)
    if device.type == "cpu":
        return span_segmin_scan(rows, seg, device=device)
    raise ValueError(f"no span scan for device {device}")


def devloop_carry(op: searchop.SearchOp, device) -> torch.Tensor:
    """``op``'s neutral carry on ``device``: the uint32 words as int32 bit
    patterns for the kernels on a CUDA device, the plain int64 words on
    the CPU."""
    words = op.init()
    device = torch.device(device)
    if device.type == "cuda":
        words = torch.where(words > 0x7FFFFFFF, words - (1 << 32), words)
        return words.to(dtype=torch.int32, device=device)
    return words.to(device)


def devloop_span(midstate, template, carry: torch.Tensor, i0: int,
                 lo_i: int, hi_i: int, n: int, base: int, *, rem: int,
                 k: int, device, grid: int | None = None, peel: bool = False,
                 hoist=None) -> torch.Tensor:
    """One block of the device-resident arg-min chain: the block's
    ``(hi, lo, idx)`` folded into the 5-word ``carry`` (nonce = ``base +
    idx``). Returns the updated carry: on a CUDA device K6 updates it in
    place without synchronising; on the CPU the plain scan and fold
    return a new one."""
    device = torch.device(device)
    hoist = hoist if peel else None
    if device.type == "cuda":
        return sha256_cuda.sha256_argmin_fold(
            midstate, template, carry, i0, lo_i, hi_i, n, base, rem=rem,
            k=k, device=device, grid=grid, peel=peel, hoist=hoist)
    if device.type == "cpu":
        hi, lo, idx = span_scan(midstate, template, i0, lo_i, hi_i, n,
                                rem=rem, k=k, device=device, hoist=hoist)
        return searchop.fold_argmin(carry, hi, lo, idx, base >> 32,
                                    base & M32)
    raise ValueError(f"no span scan for device {device}")


def devloop_span_until(midstate, template, carry: torch.Tensor, i0: int,
                       lo_i: int, hi_i: int, n: int, t_hi: int, t_lo: int,
                       base: int, *, rem: int, k: int, device,
                       grid: int | None = None, peel: bool = False,
                       hoist=None) -> torch.Tensor:
    """One block of the device-resident difficulty chain: the block's
    early-exit scan folded into the 8-word ``carry``. Once ``carry[0]``
    says an earlier block hit, the block does no lane work and the carry
    stays as it is, so the span costs one fetch wherever the hit lands.
    Returns the updated carry (in place on a CUDA device)."""
    device = torch.device(device)
    hoist = hoist if peel else None
    if device.type == "cuda":
        return sha256_cuda.sha256_until_fold(
            midstate, template, carry, i0, lo_i, hi_i, n, t_hi, t_lo, base,
            rem=rem, k=k, device=device, grid=grid, peel=peel, hoist=hoist)
    if device.type == "cpu":
        if int(carry[0]):
            return carry
        _found, f_idx, b_hi, b_lo, b_idx = span_until_scan(
            midstate, template, i0, lo_i, hi_i, n, t_hi, t_lo, rem=rem,
            k=k, device=device, hoist=hoist)
        return searchop.fold_until(carry, f_idx, b_hi, b_lo, b_idx,
                                   base >> 32, base & M32)
    raise ValueError(f"no span scan for device {device}")
