"""Lane-vectorized SHA-256 arg-min search, plain PyTorch tier.

The plain version of the CUDA kernel in ``csrc/sha256_argmin.cu`` and the
counterpart of the JAX package's ``ops/sha256_jnp.py``:

- The host splits the search into aligned ``10^k`` blocks, so every nonce
  of a block shares its top decimal digits; those join the constant
  prefix ``data + " " + top_digits``, whose complete 64-byte blocks are
  absorbed into a host midstate. Only the final 1-2 blocks are hashed
  per lane.
- A lane vector ``i`` of low-digit offsets (``i < 10^k <= 10^9``) gets
  its k ASCII digits placed into the padded tail template, runs the
  64-round compression, and keeps digest words 0 and 1 as ``(hi, lo)``.
- The exact lexicographic ``(hi, lo, idx)`` arg-min picks the lowest
  index on ties, matching the Go scan's first-seen-wins strict ``<``.

The hoist plane (:func:`hoist_structure`, :func:`build_hoist`,
:func:`compress_tail_hoisted`) is the counterpart of the JAX package's
hoisted entry path, and the plain version of the peeled kernel fed by the
host hoist (K4): the rounds before the first digit word run once per plan
on the host, the constant schedule terms of rounds 16-31 are folded into
one host word per round, and a digit-free block has its whole schedule
precombined with K.

PyTorch on the CPU has no uint32 ``+``, ``>>`` or ``<``, so every lane
is an ``int64`` tensor holding a 32-bit value: each sum is masked with
``& 0xFFFFFFFF`` and no shift exceeds 31 bits, so nothing overflows.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .sha256_host import (SHA256_K, compress_rounds, schedule_words, sigma0,
                          sigma1)

M32 = 0xFFFFFFFF


def digit_positions(rem: int, k: int) -> list[tuple[int, int, int]]:
    """Static placement of the k ASCII digit bytes inside the tail blocks.

    Digit j (most significant first) sits at byte ``rem + j``; returns
    (block, word, shift) per digit for big-endian uint32 word packing.
    """
    out = []
    for j in range(k):
        pos = rem + j
        out.append((pos // 64, (pos % 64) // 4, (3 - pos % 4) * 8))
    return out


def digit_contrib(i: torch.Tensor, rem: int, k: int) -> dict:
    """Per-(block, word) contributions of the k ASCII digit bytes of the
    lane vector ``i`` (int64, values below ``10^k``)."""
    contrib: dict[tuple[int, int], torch.Tensor] = {}
    for j, (blk, word, shift) in enumerate(digit_positions(rem, k)):
        digit = torch.div(i, 10 ** (k - 1 - j), rounding_mode="floor") % 10
        add = (digit + 48) << shift
        key = (blk, word)
        contrib[key] = contrib[key] + add if key in contrib else add
    return contrib


def build_tail_template(tail: bytes, k: int, total_len: int) -> np.ndarray:
    """Padded final block(s) as (nblocks, 16) uint32, digit bytes zeroed.

    ``tail`` is the prefix remainder (< 64 bytes); the k digit bytes follow
    it, then 0x80, zero padding, and the 64-bit message bit length.
    """
    rem = len(tail)
    msg_len = rem + k
    data = bytearray(tail) + bytes(k)  # digit positions left as 0
    data.append(0x80)
    nblocks = 1 if msg_len + 1 + 8 <= 64 else 2
    data = data.ljust(nblocks * 64 - 8, b"\x00")
    data += int(total_len * 8).to_bytes(8, "big")
    words = np.frombuffer(bytes(data), dtype=">u4").astype(np.uint32)
    return words.reshape(nblocks, 16)


def _rotr(x, n: int):
    return (x >> n) | ((x << (32 - n)) & M32)


def _round(a, b, c, d, e, f, g, h, kw):
    """One SHA-256 round; ``kw`` is the K[t] + W[t] term."""
    s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
    ch = g ^ (e & (f ^ g))
    t1 = h + s1 + ch + kw
    s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
    maj = (a & (b ^ c)) ^ (b & c)
    return ((t1 + s0 + maj) & M32, a, b, c, (d + t1) & M32, e, f, g)


def _compress(state, w16):
    """One compression: 8 state lanes and 16 message-word lanes in, the
    8 feed-forward output lanes out."""
    w = list(w16)
    for t in range(16, 64):
        x, y = w[t - 15], w[t - 2]
        s0 = _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)
        s1 = _rotr(y, 17) ^ _rotr(y, 19) ^ (y >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    st = tuple(state)
    for t in range(64):
        st = _round(*st, w[t] + SHA256_K[t])
    return tuple((s + v) & M32 for s, v in zip(state, st))


def hash_lanes(midstate, template, i: torch.Tensor, rem: int, k: int,
               hoist=None):
    """Digest words 0 and 1 of every lane in ``i`` as int64 ``(hi, lo)``.

    ``midstate``: 8 ints; ``template``: (nblocks, 16) uint32 array from
    :func:`build_tail_template`. Lanes live on ``i.device``. ``hoist`` is
    the optional operand dict of :func:`build_hoist` (``HoistPlan.ops``):
    with it the compression runs the hoisted path
    (:func:`compress_tail_hoisted`), without it the full one; both give
    the same words.
    """
    contrib = digit_contrib(i, rem, k)
    if hoist is not None:
        state = compress_tail_hoisted(midstate, template, contrib, hoist,
                                      rem=rem, k=k, like=i)
        return state[0], state[1]
    zero = torch.zeros_like(i)
    state = tuple(zero + int(m) for m in midstate)
    for blk in range(template.shape[0]):
        w16 = []
        for word in range(16):
            w = zero + int(template[blk, word])
            if (blk, word) in contrib:
                w = w | contrib[(blk, word)]
            w16.append(w)
        state = _compress(state, w16)
    return state[0], state[1]


def lex_argmin(hi, lo, idx):
    """Exact arg-min over (hi, lo) pairs; the lowest idx wins ties.
    Returns three 0-dim tensors."""
    min_hi = hi.min()
    on_hi = hi == min_hi
    min_lo = torch.where(on_hi, lo, M32).min()
    on_both = on_hi & (lo == min_lo)
    min_idx = torch.where(on_both, idx, M32).min()
    return min_hi, min_lo, min_idx


# ------------------------------------------------------------- hoist plane
#
# Only the k ASCII digit bytes at rem..rem+k-1 vary per lane, so most of a
# tail compression is the same for every lane:
#
# (a) rounds 0..rem//4-1 of block 0 read only constant words: the state
#     after them (``deep``) is computed once per plan on the host;
# (b) a schedule tap of rounds 16..31 whose source word carries no digit
#     bits is constant: the constant taps of each expanded word are
#     summed on the host into one ``cw`` word (rounds 32..63 keep the
#     full schedule);
# (c) a block without digit bytes (the padding and length block of a
#     2-block tail whose digits fit block 0) has a constant schedule:
#     ``ckw`` holds K[t] + W[t] for its 64 rounds.
#
# Which words and taps vary depends on (rem, k, nblocks) alone
# (:func:`hoist_structure`); the operands carry only values.

#: Schedule taps of w[t]: w[t-16] + s0(w[t-15]) + w[t-7] + s1(w[t-2]).
_TAPS = (("w", -16), ("s0", -15), ("w", -7), ("s1", -2))


def hoist_structure(rem: int, k: int, nblocks: int, static_rounds: int = 32):
    """Constancy analysis of the tail blocks: one ``(varying_words,
    var_taps, full_const)`` triple per block. ``varying_words`` are the
    window words that carry digit bytes; ``var_taps`` lists, for rounds
    16..``static_rounds``-1, the lane-varying taps of each expanded word
    (the constant rest is folded into ``cw``); ``full_const`` marks a
    digit-free block. ``static_rounds`` (32, or 48 for the deep window)
    must be a multiple of 16."""
    assert static_rounds % 16 == 0 and 32 <= static_rounds <= 64
    pos = digit_positions(rem, k)
    blocks = []
    for b in range(nblocks):
        varying = tuple(sorted({w for (bb, w, _) in pos if bb == b}))
        if not varying:
            blocks.append((varying, (), True))
            continue
        var = [w in varying for w in range(16)]
        taps = []
        for t in range(16, static_rounds):
            tv = tuple((kind, t + off) for kind, off in _TAPS
                       if var[t + off])
            var.append(bool(tv))
            taps.append(tv)
        blocks.append((varying, tuple(taps), False))
    # Block 0 always holds the first digit byte (rem < 64), so only the
    # last block of a tail can be digit-free.
    assert not any(full for _, _, full in blocks[:-1])
    return tuple(blocks)


@dataclass(frozen=True)
class HoistPlan:
    """Host-precomputed lane-invariant work for one tail template, built
    once per midstate-cache entry; the matching structure is re-derived
    from (rem, k, nblocks) by :func:`hoist_structure`."""
    wd0: int            #: rounds of block 0 hoisted into ``deep``
    nblocks: int
    full_const: tuple   #: per block: the schedule is constant
    ops: dict           #: deep / kw / cw (+ cw2) (+ ckw)


def build_hoist(midstate, template: np.ndarray, rem: int, k: int,
                deep_window: bool = False) -> HoistPlan:
    """The hoist operands of one (midstate, template) pair, as uint32
    numpy arrays: ``deep`` (8,), the round state after the first
    ``rem // 4`` rounds of block 0; ``kw`` (nblocks, 16), K[j] + W[j] for
    rounds 0..15 (a digit word adds its lane contribution on top, exact
    because the template's digit bytes are zero); ``cw`` (nblocks, 16),
    the constant part of each expanded word w[16..31]; ``ckw`` (64,),
    K[t] + W[t] of the digit-free block, when there is one.

    ``deep_window`` extends the static window to rounds 16..47: the
    constant terms of w[32..47] ride an extra ``cw2`` (nblocks, 16),
    which only the plain hoisted compression reads (the kernel, like the
    TPU one, reads 16 ``cw`` words per block)."""
    static_rounds = 48 if deep_window else 32
    nblocks = int(template.shape[0])
    struct = hoist_structure(rem, k, nblocks, static_rounds)
    wd0 = struct[0][0][0]   # first digit word of block 0 == rem // 4
    deep = compress_rounds(midstate, [int(x) for x in template[0]], 0, wd0)
    kw = np.zeros((nblocks, 16), dtype=np.uint32)
    cw = np.zeros((nblocks, static_rounds - 16), dtype=np.uint32)
    ckw = None
    for b, (_varying, taps, full) in enumerate(struct):
        words = [int(x) for x in template[b]]
        if full:
            sched = schedule_words(words)
            ckw = np.asarray([(SHA256_K[t] + sched[t]) & M32
                              for t in range(64)], dtype=np.uint32)
            continue
        kw[b] = [(SHA256_K[j] + words[j]) & M32 for j in range(16)]
        vals: list = words + [None] * (static_rounds - 16)
        for i, tv in enumerate(taps):
            t = 16 + i
            acc = 0
            for kind, off in _TAPS:
                if (kind, t + off) in tv:
                    continue
                v = vals[t + off]
                acc += (v if kind == "w"
                        else sigma0(v) if kind == "s0" else sigma1(v))
            cw[b, i] = acc & M32
            if not tv:
                vals[t] = int(cw[b, i])
    ops = {"deep": np.asarray(deep, dtype=np.uint32), "kw": kw,
           "cw": cw[:, :16]}
    if static_rounds > 32:
        ops["cw2"] = cw[:, 16:]
    if ckw is not None:
        ops["ckw"] = ckw
    return HoistPlan(wd0=wd0, nblocks=nblocks,
                     full_const=tuple(s[2] for s in struct), ops=ops)


def _sig0(x):
    return _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)


def _sig1(x):
    return _rotr(x, 17) ^ _rotr(x, 19) ^ (x >> 10)


def _compress_const_block(ff, ckw):
    """Compression of a digit-free block: 64 rounds off the host's
    K[t] + W[t] words, no schedule arithmetic. ``ff`` is the block's
    input state (and feed-forward base)."""
    st = tuple(ff)
    for t in range(64):
        st = _round(*st, int(ckw[t]))
    return tuple((f + s) & M32 for f, s in zip(ff, st))


def _compress_block_hoisted(ff, entry, wd, varying, taps, contribs, tw,
                            kwv, cwv):
    """Hoisted compression of one digit-carrying block. ``ff`` is the
    block's input state (the feed-forward base), ``entry`` the state it
    enters round ``wd`` with (block 0: the host's deep state; a later
    block: ``ff`` with ``wd == 0``). Rounds wd..15 run off ``kwv`` (plus
    the lane's digits on a varying word), rounds 16..15+len(taps)
    compute only the varying taps on top of ``cwv``, the rest run the
    full schedule."""
    st = tuple(entry)
    for j in range(wd, 16):
        kwj = kwv[j] + contribs[j] if j in varying else kwv[j]
        st = _round(*st, kwj)
    wv = {j: tw[j] + contribs[j] for j in varying}
    for i, tv in enumerate(taps):
        t = 16 + i
        acc = cwv[i]
        for kind, tap in tv:
            x = wv[tap]
            acc = acc + (x if kind == "w"
                         else _sig0(x) if kind == "s0" else _sig1(x))
        acc = acc & M32 if tv else acc
        wv[t] = acc
        st = _round(*st, acc + SHA256_K[t])
    w = [wv[t] for t in range(len(taps), len(taps) + 16)]
    for t in range(16 + len(taps), 64):
        x, y = w[t - 15 - len(taps)], w[t - 2 - len(taps)]
        wt = (w[t - 16 - len(taps)] + _sig0(x) + w[t - 7 - len(taps)]
              + _sig1(y)) & M32
        w.append(wt)
        st = _round(*st, wt + SHA256_K[t])
    return tuple((f + s) & M32 for f, s in zip(ff, st))


def compress_tail_hoisted(midstate, template, contrib, hoist_ops, *,
                          rem: int, k: int, like: torch.Tensor):
    """The hoisted tail compression: the 8 output words (int64 lanes
    shaped like ``like``, or ints where a word is the same for every
    lane). ``contrib`` is :func:`digit_contrib`'s dict, ``hoist_ops`` the
    operands of :func:`build_hoist`; the static window is 48 rounds when
    they hold ``cw2``, else 32. Gives the words of the full compression,
    bit for bit."""
    nblocks = int(template.shape[0])
    static_rounds = 48 if "cw2" in hoist_ops else 32
    struct = hoist_structure(rem, k, nblocks, static_rounds)
    deep = [int(x) for x in hoist_ops["deep"]]
    kw = np.asarray(hoist_ops["kw"], dtype=np.int64)
    cw = np.asarray(hoist_ops["cw"], dtype=np.int64)
    if static_rounds > 32:
        cw = np.concatenate([cw, np.asarray(hoist_ops["cw2"],
                                            dtype=np.int64)], axis=1)
    zero = torch.zeros_like(like)
    out = None
    for b, (varying, taps, full) in enumerate(struct):
        ff = tuple(int(m) for m in midstate) if b == 0 else out
        if full:
            out = _compress_const_block(ff, hoist_ops["ckw"])
            continue
        entry = deep if b == 0 else ff
        wd = struct[0][0][0] if b == 0 else 0
        out = _compress_block_hoisted(
            ff, entry, wd, varying, taps,
            {w: contrib[(b, w)] for w in varying},
            tw=[int(x) for x in template[b]],
            kwv=[int(x) for x in kw[b]],
            cwv=[int(x) for x in cw[b]])
    return tuple(x if isinstance(x, torch.Tensor) else zero + x
                 for x in out)
