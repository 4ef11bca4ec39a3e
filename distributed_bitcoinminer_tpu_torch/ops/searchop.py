"""Search-op seam: carry codec and merge rule behind one small protocol.

Counterpart of the JAX package's ``ops/searchop.py``. A search op is (a) a
carry layout, the few uint32 words of running state a launch consumes and
emits, (b) a fold, how one launch's merged candidate enters that carry,
and (c) a decode, how the host reads the final carry back into Python
values. The arg-min op (minimal (hash, nonce)) and the until op (first
*qualifying* nonce, arg-min fallback) are the two instances.

The device-resident span loop (``ops.search.devloop_span`` and
``devloop_span_until``) threads these words through every block of a span,
so a whole span crosses to the host as ONE vector of 5 (arg-min) or 8
(until) words, fetched once. On a CUDA device the kernels of
``csrc/sha256_argmin.cu`` fold on the card with the same rule; the
functions here are the plain PyTorch version and the CPU path. Words are
held in int64 tensors, each a uint32 value (PyTorch on the CPU has no
uint32 ``+`` or ``<``).

Merge rule (both ops): full lexicographic strict-less on
(hash_hi, hash_lo, nonce_hi, nonce_lo) among seen candidates: minimal
hash, earliest nonce on ties, the host ``finalize`` walk and the Go scan's
first-seen-wins strict ``<`` (ref: bitcoin/miner/miner.go:54-58).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

M32 = 0xFFFFFFFF
_MAX_U64 = (1 << 64) - 1

#: Carry layouts (uint32 words).
#: argmin: [hash_hi, hash_lo, nonce_hi, nonce_lo, seen]
#: until:  [found, f_nonce_hi, f_nonce_lo] + the argmin layout.
CARRY_WORDS = 5
UNTIL_CARRY_WORDS = 8


def carry_init() -> torch.Tensor:
    """Neutral argmin carry: nothing seen yet."""
    return torch.tensor([M32] * 4 + [0], dtype=torch.int64)


def until_carry_init() -> torch.Tensor:
    """Neutral difficulty carry: no hit, nothing seen."""
    return torch.tensor([0, M32, M32] + [M32] * 4 + [0], dtype=torch.int64)


def _word(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (int or tensor) as an int64 0-d word on ``like``'s device."""
    return torch.as_tensor(x, dtype=torch.int64, device=like.device) & M32


def lex_less(a, b):
    """Strict lexicographic ``a < b`` over matching leading words of two
    word vectors (element 0 most significant)."""
    out = a[-1] < b[-1]
    for i in range(len(a) - 2, -1, -1):
        out = (a[i] < b[i]) | ((a[i] == b[i]) & out)
    return out


def global_nonce(base_hi, base_lo, idx):
    """64-bit ``base + idx`` as a (hi, lo) word pair (idx < 2^32; the
    unsigned-add wrap test carries into the high word)."""
    n_lo = (base_lo + idx) & M32
    return (base_hi + (n_lo < idx).to(torch.int64)) & M32, n_lo


def fold_argmin(carry, m_hi, m_lo, m_idx, base_hi, base_lo):
    """Fold one launch's merged candidate into the argmin carry."""
    m_hi, m_lo, m_idx, base_hi, base_lo = (
        _word(x, carry) for x in (m_hi, m_lo, m_idx, base_hi, base_lo))
    valid = ~((m_hi == M32) & (m_lo == M32) & (m_idx == M32))
    n_hi, n_lo = global_nonce(base_hi, base_lo, m_idx)
    cand = torch.stack([m_hi, m_lo, n_hi, n_lo])
    prev = carry[:4]
    better = valid & ((carry[4] == 0) | lex_less(cand, prev))
    best = torch.where(better, cand, prev)
    seen = torch.where(better, torch.ones_like(carry[4]), carry[4])
    return torch.cat([best, seen[None]])


def fold_until(carry, f_idx, b_hi, b_lo, b_idx, base_hi, base_lo):
    """Fold one launch's first-hit lane + argmin fallback into the 8-word
    difficulty carry.

    ``f_idx`` is the window's minimal qualifying lane (all-ones when none):
    the carry keeps the LOWER 64-bit qualifying nonce across folds (the
    min, not first-write-wins), and the argmin fallback folds exactly like
    :func:`fold_argmin`; it answers only when the whole span misses the
    target.
    """
    f_idx, base_hi, base_lo = (_word(x, carry)
                               for x in (f_idx, base_hi, base_lo))
    cand_found = f_idx != M32
    f_hi, f_lo = global_nonce(base_hi, base_lo, f_idx)
    fcand = torch.stack([f_hi, f_lo])
    prev_f = carry[1:3]
    f_better = cand_found & ((carry[0] == 0) | lex_less(fcand, prev_f))
    new_f = torch.where(f_better, fcand, prev_f)
    new_found = torch.maximum(carry[0], cand_found.to(torch.int64))
    tail = fold_argmin(carry[3:], b_hi, b_lo, b_idx, base_hi, base_lo)
    return torch.cat([new_found[None], new_f, tail])


def _host_words(words, count: int) -> list[int]:
    """The first ``count`` words of a fetched carry (a tensor of any
    integer type, or a sequence of ints) as uint32 Python ints."""
    if isinstance(words, torch.Tensor):
        words = words.reshape(-1).tolist()
    return [int(x) & M32 for x in list(words)[:count]]


def decode_argmin(words, default_nonce: int) -> Tuple[int, int]:
    """Host decode of a fetched argmin carry -> (best_hash, nonce).

    An unseen carry (empty effective range) decodes to the MAX-hash
    sentinel at ``default_nonce``, the same contract as an all-invalid
    host-merged span.
    """
    v = _host_words(words, CARRY_WORDS)
    if not v[4]:
        return _MAX_U64, int(default_nonce)
    return (v[0] << 32) | v[1], (v[2] << 32) | v[3]


def decode_until(words, default_nonce: int
                 ) -> Tuple[bool, int, int, int]:
    """Host decode of a fetched until carry ->
    ``(found, f_nonce, best_hash, best_nonce)``. The qualifying HASH is
    absent: the model layer recomputes that one value with the host
    oracle."""
    v = _host_words(words, UNTIL_CARRY_WORDS)
    found = bool(v[0])
    f_nonce = (v[1] << 32) | v[2]
    best_hash, best_nonce = decode_argmin(v[3:], default_nonce)
    return found, f_nonce, best_hash, best_nonce


@dataclasses.dataclass(frozen=True)
class SearchOp:
    """The op protocol a device-resident span loop needs: ``init``
    mints the neutral carry, ``fold`` merges one launch's candidate into
    it, ``decode`` reads the fetched words on the host. How lanes are
    hashed and reduced to a candidate stays with the span code
    (``ops/search.py`` and the CUDA kernels)."""
    name: str
    carry_words: int
    init: Callable[[], torch.Tensor]
    fold: Callable[..., torch.Tensor]
    decode: Callable[..., tuple]

    @property
    def nbytes(self) -> int:
        """Size of the per-span host transfer this op costs."""
        return 4 * self.carry_words


ARGMIN_OP = SearchOp("argmin", CARRY_WORDS, carry_init,
                     fold_argmin, decode_argmin)
UNTIL_OP = SearchOp("until", UNTIL_CARRY_WORDS, until_carry_init,
                    fold_until, decode_until)
