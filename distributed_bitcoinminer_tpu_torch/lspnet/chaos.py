"""Searcher wrappers that make a miner fail without losing its connection.

Counterpart of the searcher half of the JAX package's ``lspnet/chaos.py``:

- :class:`WedgeableSearcher` hangs the compute until its gate is set,
  modelling a card stuck inside a kernel behind a healthy LSP connection
  (the failure the scheduler's chunk leases exist for);
- :class:`ByzantineSearcher` makes the answers lie (:data:`BYZANTINE_MODES`),
  the failure the verification tier's claim checks and audits exist for.

Both wrap ``search`` and ``search_until`` only, so a miner serves them
through its blocking path, one chunk at a time, on a worker thread while
its event loop keeps the connection alive.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..bitcoin.hash import hash_op


class WedgeableSearcher:
    """Wrap a searcher so its compute can be hung and released at will:
    while ``gate`` is clear, ``search``/``search_until`` block."""

    def __init__(self, inner, gate: Optional[threading.Event] = None):
        self._inner = inner
        if gate is None:
            gate = threading.Event()
            gate.set()
        self.gate = gate
        # Claim the until extension only when the inner searcher speaks
        # it: the miner echoes a Request's target iff the attribute is
        # there, and the scheduler grades its merge by that echo.
        if not hasattr(inner, "search_until"):
            self.search_until = None

    def search(self, lower: int, upper: int):
        self.gate.wait()
        return self._inner.search(lower, upper)

    def search_until(self, lower: int, upper: int, target: int):
        self.gate.wait()
        return self._inner.search_until(lower, upper, target)


#: The lies. ``wrong_hash`` claims hash 0 at the range's first nonce,
#: which the claim check rejects; ``sentinel`` claims the true hash of the
#: range's first nonce without scanning, which only an audit can catch;
#: ``selective`` alternates honest and sentinel answers.
BYZANTINE_MODES = ("wrong_hash", "sentinel", "selective")


class ByzantineSearcher:
    """Wrap a searcher so its answers lie per ``mode`` while ``lie_flag``
    is set, and pass through to the inner searcher while it is clear."""

    def __init__(self, inner, data: str, mode: str,
                 lie_flag: threading.Event):
        if mode not in BYZANTINE_MODES:
            raise ValueError(f"unknown mode {mode!r}")
        self._inner = inner
        self._data = data
        self._mode = mode
        self._lie_flag = lie_flag
        self._calls = 0
        if not hasattr(inner, "search_until"):
            self.search_until = None

    def _fabricate(self, lower: int):
        """This call's lie, or None to answer honestly."""
        if not self._lie_flag.is_set():
            return None
        self._calls += 1
        if self._mode == "selective" and self._calls % 2:
            return None
        if self._mode == "wrong_hash":
            return (0, lower)
        return (hash_op(self._data, lower), lower)

    def search(self, lower: int, upper: int):
        out = self._fabricate(lower)
        return out if out is not None else self._inner.search(lower, upper)

    def search_until(self, lower: int, upper: int, target: int):
        out = self._fabricate(lower)
        if out is not None:
            h, nonce = out
            return (h, nonce, h < target)
        return self._inner.search_until(lower, upper, target)
