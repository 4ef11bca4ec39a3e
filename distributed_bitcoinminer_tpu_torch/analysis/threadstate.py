"""Analyzer: cross-thread attribute ownership (thread-state).

The bug class: the scheduler and miner are asyncio actors whose compute
hops to worker threads (``asyncio.to_thread``, executors). An attribute
mutated from BOTH domains is a data race unless something serializes it
— and "something" must be on record, or the next PR breaks it silently.

Scope: the classes named in :data:`CLASSES` (the stack's stateful
actors). Per class:

1. seed the THREAD side with every method handed to a thread dispatcher
   (``asyncio.to_thread(self.m, ...)``, ``executor.submit(self.m)``,
   ``Thread(target=self.m)``, ``run_in_executor(None, self.m)``) and
   close over same-class ``self.m()`` calls;
2. collect per-method ``self.<attr>`` WRITES (assignment, aug-assign,
   subscript stores, and mutating method calls — append/pop/update/…)
   and READS; ``__init__`` is construction-time and belongs to neither
   domain;
3. an attribute written on the thread side and touched on the loop side
   (or vice versa) must either appear in the class's ``THREAD_SHARED``
   ownership table (``{"attr": "why this is serialized"}`` — the
   machine-checked design record) or be accessed under a ``with
   self.<...lock...>:`` block.

The runtime complement (``utils/sanitize.py``, ``DBMT_SANITIZE=1``)
asserts the same ownership dynamically; this analyzer keeps the table
honest at review time.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from .core import Finding, SourceFile, dotted

NAME = "thread-state"

#: class name -> file suffix it lives in (scope filter).
CLASSES = {
    "Scheduler": "apps/scheduler.py",
    "QosPlane": "apps/qos.py",
    "MinerWorker": "apps/miner.py",
}

THREAD_DISPATCHERS = ("to_thread", "submit", "run_in_executor")
MUTATORS = {
    "append", "extend", "insert", "pop", "popitem", "remove", "clear",
    "update", "setdefault", "add", "discard", "move_to_end", "appendleft",
    "popleft", "inc", "observe",
}


def _self_method_ref(node: ast.expr):
    """'m' when ``node`` is ``self.m``."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _thread_seeds(cls: ast.ClassDef) -> Set[str]:
    seeds: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Call):
            continue
        fname = dotted(node.func)
        if not fname.split(".")[-1] in THREAD_DISPATCHERS and \
                not fname.endswith("Thread"):
            continue
        candidates = list(node.args)
        for kw in node.keywords:
            if kw.arg == "target":
                candidates.append(kw.value)
        for arg in candidates:
            m = _self_method_ref(arg)
            if m is not None:
                seeds.add(m)
    return seeds


def _method_calls(fn: ast.AST) -> Set[str]:
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            m = _self_method_ref(node.func)
            if m is not None:
                out.add(m)
    return out


def _attr_accesses(fn: ast.AST):
    """(writes, reads) of ``self.<attr>`` in ``fn``; a write via a
    mutating method call or subscript store counts as a write. Accesses
    inside ``with self.<...lock...>`` blocks are excluded (serialized)."""
    writes: Dict[str, int] = {}
    reads: Dict[str, int] = {}

    def locked(with_node: ast.With) -> bool:
        for item in with_node.items:
            name = dotted(item.context_expr).lower()
            if "lock" in name:
                return True
        return False

    def visit(node):
        if isinstance(node, ast.With) and locked(node):
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                base = tgt
                if isinstance(base, ast.Subscript):
                    base = base.value
                attr = _self_method_ref(base)
                if attr is not None:
                    writes[attr] = getattr(tgt, "lineno", node.lineno)
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) and \
                    func.attr in MUTATORS:
                attr = _self_method_ref(func.value)
                if attr is not None:
                    writes[attr] = node.lineno
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self" and isinstance(node.ctx, ast.Load):
            reads.setdefault(node.attr, node.lineno)
        for child in ast.iter_child_nodes(node):
            visit(child)

    for stmt in getattr(fn, "body", []):
        visit(stmt)
    return writes, reads


def _ownership_table(cls: ast.ClassDef) -> Set[str]:
    """Keys of a class-level ``THREAD_SHARED = {...}`` dict."""
    for node in cls.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "THREAD_SHARED" \
                        and isinstance(node.value, ast.Dict):
                    return {k.value for k in node.value.keys
                            if isinstance(k, ast.Constant)}
    return set()


def analyze(files: List[SourceFile], repo: str) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        if f.tree is None:
            continue
        for cls in ast.walk(f.tree):
            if not isinstance(cls, ast.ClassDef) or \
                    cls.name not in CLASSES:
                continue
            if not f.rel.endswith(CLASSES[cls.name]) and \
                    "fixture" not in f.rel:
                continue
            methods = {n.name: n for n in cls.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
            # Transitive closure of thread-side methods.
            thread_side = set()
            frontier = {m for m in _thread_seeds(cls) if m in methods}
            while frontier:
                m = frontier.pop()
                if m in thread_side:
                    continue
                thread_side.add(m)
                frontier |= {c for c in _method_calls(methods[m])
                             if c in methods and c not in thread_side}
            if not thread_side:
                continue
            loop_side = {m for m in methods
                         if m not in thread_side and m != "__init__"}
            table = _ownership_table(cls)
            t_writes: Dict[str, int] = {}
            t_reads: Dict[str, int] = {}
            l_writes: Dict[str, int] = {}
            l_reads: Dict[str, int] = {}
            for m in thread_side:
                w, r = _attr_accesses(methods[m])
                for a, ln in w.items():
                    t_writes.setdefault(a, ln)
                for a, ln in r.items():
                    t_reads.setdefault(a, ln)
            for m in loop_side:
                w, r = _attr_accesses(methods[m])
                for a, ln in w.items():
                    l_writes.setdefault(a, ln)
                for a, ln in r.items():
                    l_reads.setdefault(a, ln)
            # A race needs a WRITE on one side and any touch on the
            # other: thread-written + loop-touched, or loop-written +
            # thread-read (the "vice versa" direction — a torn read off
            # the owning thread is just as much a race).
            shared = {}
            for attr, ln in t_writes.items():
                if attr in l_writes or attr in l_reads:
                    shared[attr] = ln
            for attr, ln in t_reads.items():
                if attr in l_writes:
                    shared.setdefault(attr, ln)
            for attr, ln in sorted(shared.items()):
                if attr in table:
                    continue
                out.append(Finding(
                    NAME, f.rel, ln,
                    f"{NAME}:{f.rel}:{cls.name}:{attr}",
                    f"{cls.name}.{attr} is touched from both worker-"
                    f"thread and event-loop method(s) with a write on "
                    f"at least one side; declare it in "
                    f"{cls.name}.THREAD_SHARED with the serialization "
                    f"argument, or guard both sides with a lock"))
    return out
