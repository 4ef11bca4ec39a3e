"""Analyzer: lock discipline in the asyncio actors (lock-discipline).

Two bug shapes, both invisible to tests until the scheduler is under
real concurrency (which is exactly when they fire — dbmcheck's
deterministic explorer motivates pinning them statically too):

1. **A synchronous (threading) lock held across an ``await``.** A
   coroutine that does ``with self._lock: ... await ...`` parks while
   HOLDING the lock; any worker thread that then touches the same lock
   blocks — and if that worker is the one whose completion the
   coroutine awaits, the process deadlocks. (``async with`` over an
   asyncio lock is the correct shape: it suspends, never blocks the
   loop.) Any ``with``-statement whose context expression looks like a
   lock and whose DIRECT body contains an ``await`` / ``async for`` /
   ``async with`` is flagged.

2. **A blocking call under ANY lock.** Whether the lock is a threading
   or an asyncio one, running the loop-block analyzer's blocking
   surface (subprocess, kernel builds, device-result forcing,
   searcher construction/scan, ``time.sleep``) while holding it turns one slow call into a convoy:
   every other acquirer — event loop or worker thread — queues behind
   a kernel build. Flagged in both ``with`` and ``async
   with`` bodies.

Scope: ``apps/`` and ``lsp/`` (the asyncio actors), like loop-block.

What counts as a lock (curated, AST-level): a context expression whose
dotted name's last segment IS ``lock``/``mutex``/``cond``/``condition``
or ends in the ``_``-separated word (``state_lock`` yes,
``datablock`` no; leading underscores stripped; case-insensitive;
with or without a trailing ``()`` acquire-style call), or any name
bound — anywhere in the same file — from ``threading.Lock()`` /
``RLock`` / ``Condition`` / ``Semaphore`` / ``BoundedSemaphore`` or
their ``asyncio`` analogs.
Suppressions (``# dbmlint: ok[lock-discipline] why``) must state the
boundedness argument — why the critical section cannot convoy.
"""

from __future__ import annotations

import ast
from typing import List, Set

from .core import Finding, SourceFile, direct_body, dotted, scope_map
from .loopblock import _blocking_reason

NAME = "lock-discipline"

SCOPE_PREFIXES = (
    "distributed_bitcoinminer_tpu_torch/apps/",
    "distributed_bitcoinminer_tpu_torch/lsp/",
)

#: Constructor names whose assignment target becomes a known lock.
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}

_NAME_HINTS = ("lock", "mutex", "cond", "condition")


def _lock_names(tree: ast.AST) -> Set[str]:
    """Dotted names assigned from a lock constructor anywhere in the
    file (``self._m = threading.Lock()`` -> "self._m")."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        elif isinstance(node, ast.AnnAssign):   # x: Lock = Lock()
            targets = [node.target]
            value = node.value
        else:
            continue
        if not isinstance(value, ast.Call):
            continue
        ctor = dotted(value.func)
        if ctor.split(".")[-1] not in _LOCK_CTORS:
            continue
        for target in targets:
            if isinstance(target, (ast.Name, ast.Attribute)):
                out.add(dotted(target))
    return out


def _is_lock_expr(expr: ast.AST, known: Set[str]) -> bool:
    """Heuristic: the context expression of a with-statement is a lock."""
    if isinstance(expr, ast.Call):
        # `with x.acquire():`-style or `with Lock():` inline.
        inner = dotted(expr.func)
        if inner.split(".")[-1] in _LOCK_CTORS:
            return True
        expr = expr.func
    name = dotted(expr)
    if name in known:
        return True
    # Word-boundary matching only: `state_lock`, `_lock`, `cond` — NOT
    # `datablock`/`prev_block` (a bare endswith would class any
    # identifier merely ending in "lock" as a lock and flood the
    # analyzer with false findings).
    last = name.split(".")[-1].lower().lstrip("_")
    return any(last == h or last.endswith("_" + h) for h in _NAME_HINTS)


def _scan_with(node, is_async: bool, known: Set[str], f: SourceFile,
               scope: str, out: List[Finding]) -> None:
    lock_items = [item for item in node.items
                  if _is_lock_expr(item.context_expr, known)]
    if not lock_items:
        return
    lock_name = dotted(lock_items[0].context_expr)
    for sub in direct_body(node.body):
        if not is_async and isinstance(
                sub, (ast.Await, ast.AsyncFor, ast.AsyncWith)):
            out.append(Finding(
                NAME, f.rel, sub.lineno,
                f"{NAME}:{f.rel}:{scope}:{lock_name}:await",
                f"sync lock {lock_name} held across an await in "
                f"{scope}: the coroutine parks holding it and any "
                f"worker thread acquiring it blocks (deadlock shape) "
                f"— use an asyncio lock (async with) or release "
                f"before awaiting"))
        if isinstance(sub, ast.Call):
            reason = _blocking_reason(sub)
            if reason is not None:
                out.append(Finding(
                    NAME, f.rel, sub.lineno,
                    f"{NAME}:{f.rel}:{scope}:{lock_name}:"
                    f"{dotted(sub.func)}",
                    f"blocking {reason} under lock {lock_name} in "
                    f"{scope}: one slow call convoys every other "
                    f"acquirer — move it outside the critical "
                    f"section"))


def analyze(files: List[SourceFile], repo: str) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        if f.tree is None or not f.rel.startswith(SCOPE_PREFIXES):
            continue
        known = _lock_names(f.tree)
        scopes = scope_map(f.tree)
        for node in ast.walk(f.tree):
            if isinstance(node, ast.With):
                _scan_with(node, False, known, f,
                           scopes.get(id(node), "<module>"), out)
            elif isinstance(node, ast.AsyncWith):
                _scan_with(node, True, known, f,
                           scopes.get(id(node), "<module>"), out)
    return out
