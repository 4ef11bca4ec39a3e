"""Analyzer: runtime-derived values at a kernel build boundary (build-static).

The bug class: a value that picks WHAT gets compiled — the lane body of
the CUDA library (``-DDBMT_BODY``), the library a launch loads — is a
build signature. Every DISTINCT value is a fresh ``nvcc`` run (about 50
s on the H100's host) or a fresh ``g++`` run for the host tier, and a
value derived from runtime state with an unbounded value set would run
that build mid-serve and blow 2 s leases. It is the recompile storm of a
jitted static argument, moved to where the port compiles: the build and
load of its kernel libraries (``ops/sha256_cuda.py``: ``_nvcc_command``,
``build_all``, ``build``, ``load``; the occupancy query
``default_grid``, which loads its body's library). The host tier's
``ops/sha256_native.build/load`` and the ALU probe's
``ops/alu_probe.build/load`` compile one fixed source and take no
argument, so no call site can pick what they build and they are not
registered. Build arguments must come from QUANTIZED value sets: the
three lane bodies, the three tail variants.

Scope: ``ops/``, ``models/``, ``parallel/``, ``apps/``. Two passes:

1. the boundaries are a registry (:data:`BOUNDARIES`): each entry names
   a module and a function and lists its parameters by position, the
   shape-determining ones by name (``None`` for the others). A call
   site matches as ``<module>.<func>(...)`` (any receiver whose last
   segment is the module's name), as a bare ``<func>(...)`` inside the
   module itself, or under the name a ``from ... <module> import`` gave
   it;
2. at every call site of a boundary, classify each shape-determining
   argument's expression (positional or keyword):

   - **stable**: literals; attribute chains (precomputed state such as
     ``plan.rem`` — quantization happened where the plan was built);
     names that don't resolve to a local assignment (parameters, loop
     targets — the value was quantized upstream and the site is
     auditable); names whose single local assignment is itself stable;
     tuples/unary ops/boolean comparisons of stable parts; constant
     arithmetic.
   - **unstable** (finding): arithmetic on runtime values, function-call
     results, subscripts — computed AT the boundary, where nothing
     enforces a bounded value set. Sites that ARE bounded by
     construction document it with
     ``# dbmlint: ok[build-static] <why bounded>``.

   Calls to a registered QUANTIZER (``BOUNDED_CALLS``) are stable by
   definition: the function's whole contract is to collapse a runtime
   value onto a bounded set — ``body_of`` maps ``(peel, hoist)`` onto
   the three lane bodies, ``variant_of`` a tail onto the three kernel
   variants. Teaching the analyzer the quantizer (instead of
   suppressing per site) keeps every future call site machine-checked:
   an unquantized value at a build boundary still fails.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from .core import Finding, SourceFile, dotted

NAME = "build-static"

#: Registered quantizers: calls whose RESULT is bounded by the callee's
#: contract (see module docstring). Matched on the dotted name's last
#: segment so both ``body_of(...)`` and ``sha256_cuda.body_of(...)``
#: resolve.
BOUNDED_CALLS = {"body_of", "variant_of"}

#: ``(module, function) -> parameters by position``: the name of each
#: shape-determining parameter, ``None`` for the others.
BOUNDARIES: Dict[Tuple[str, str], Tuple[Optional[str], ...]] = {
    ("sha256_cuda", "_nvcc_command"): ("body", None),
    ("sha256_cuda", "build_all"): ("bodies",),
    ("sha256_cuda", "build"): ("body",),
    ("sha256_cuda", "load"): ("body",),
    ("sha256_cuda", "default_grid"): (None, "body", "entry", "variant"),
}

SCOPE_PREFIXES = (
    "distributed_bitcoinminer_tpu_torch/ops/",
    "distributed_bitcoinminer_tpu_torch/models/",
    "distributed_bitcoinminer_tpu_torch/parallel/",
    "distributed_bitcoinminer_tpu_torch/apps/",
)

_MODULES = {mod for mod, _fn in BOUNDARIES}


def _imported(tree: ast.AST) -> Dict[str, Tuple[str, str]]:
    """Local name -> boundary for ``from ...<module> import fn [as x]``."""
    out: Dict[str, Tuple[str, str]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom) or not node.module:
            continue
        mod = node.module.rsplit(".", 1)[-1]
        for alias in node.names:
            if (mod, alias.name) in BOUNDARIES:
                out[alias.asname or alias.name] = (mod, alias.name)
    return out


def _boundary(call: ast.Call, own_module: str,
              imported: Dict[str, Tuple[str, str]]):
    """The boundary ``call`` reaches, or None."""
    func = call.func
    if isinstance(func, ast.Attribute):
        recv = dotted(func.value).rsplit(".", 1)[-1]
        key = (recv, func.attr)
        return key if key in BOUNDARIES else None
    if isinstance(func, ast.Name):
        if (own_module, func.id) in BOUNDARIES:
            return (own_module, func.id)
        return imported.get(func.id)
    return None


def _local_assignments(fn: ast.AST) -> Dict[str, List[ast.expr]]:
    """name -> assigned value exprs in ``fn``'s own body (nested defs
    excluded). Tuple-unpack targets map to a sentinel None (a slice of a
    call result — unresolvable, treated unstable)."""
    out: Dict[str, List] = {}
    stack = list(getattr(fn, "body", []))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.setdefault(tgt.id, []).append(node.value)
                elif isinstance(tgt, (ast.Tuple, ast.List)):
                    for el in tgt.elts:
                        if isinstance(el, ast.Name):
                            out.setdefault(el.id, []).append(None)
        elif isinstance(node, ast.AugAssign) and \
                isinstance(node.target, ast.Name):
            out.setdefault(node.target.id, []).append(None)
        for child in ast.iter_child_nodes(node):
            stack.append(child)
    return out


def _stable(expr: Optional[ast.expr], assigns: Dict[str, List],
            depth: int = 0) -> bool:
    if expr is None or depth > 4:
        return False
    if isinstance(expr, ast.Constant):
        return True
    if isinstance(expr, ast.Attribute):
        return True          # precomputed state; quantized at the source
    if isinstance(expr, ast.Name):
        values = assigns.get(expr.id)
        if values is None:
            return True      # parameter / loop target: quantized upstream
        if len(values) != 1:
            return False     # multi-assigned: value set untracked
        return _stable(values[0], assigns, depth + 1)
    if isinstance(expr, (ast.Tuple, ast.List)):
        return all(_stable(el, assigns, depth + 1) for el in expr.elts)
    if isinstance(expr, ast.UnaryOp):
        return _stable(expr.operand, assigns, depth + 1)
    if isinstance(expr, ast.Compare):
        return True          # bool result: two-valued signature set
    if isinstance(expr, ast.IfExp):
        # Branch on anything; the VALUE set is the two branches' union.
        return _stable(expr.body, assigns, depth + 1) and \
            _stable(expr.orelse, assigns, depth + 1)
    if isinstance(expr, ast.BinOp):
        # Constant folding only: arithmetic on runtime values is exactly
        # the hazard.
        return isinstance(expr.left, ast.Constant) and \
            isinstance(expr.right, ast.Constant)
    if isinstance(expr, ast.Call):
        fname = dotted(expr.func)
        if fname in ("bool", "str"):   # bounded / non-shape coercions
            return all(_stable(a, assigns, depth + 1) for a in expr.args)
        if fname.rsplit(".", 1)[-1] in BOUNDED_CALLS:
            return True   # registered quantizer: bounded by contract
        return False
    return False


def _shape_args(call: ast.Call, params: Tuple[Optional[str], ...]):
    """(param name, expr) of every shape-determining argument passed."""
    for pos, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            return
        if pos < len(params) and params[pos] is not None:
            yield params[pos], arg
    named = {p for p in params if p is not None}
    for kw in call.keywords:
        if kw.arg in named:
            yield kw.arg, kw.value


def analyze(files: List[SourceFile], repo: str) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        if f.tree is None or not f.rel.startswith(SCOPE_PREFIXES):
            continue
        own = f.rel.rsplit("/", 1)[-1][:-3]
        own = own if own in _MODULES else ""
        imported = _imported(f.tree)
        # Walk function-by-function so call sites resolve local names.
        funcs = [n for n in ast.walk(f.tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for fn in funcs:
            assigns = _local_assignments(fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                key = _boundary(node, own, imported)
                if key is None:
                    continue
                cname = key[1]
                for param, expr in _shape_args(node, BOUNDARIES[key]):
                    if _stable(expr, assigns):
                        continue
                    out.append(Finding(
                        NAME, f.rel, expr.lineno,
                        f"{NAME}:{f.rel}:{fn.name}:{cname}:{param}",
                        f"build argument {param!r} of {key[0]}.{cname}() "
                        f"is computed at the call boundary in "
                        f"{fn.name}(); every distinct value is a fresh "
                        f"kernel build — quantize the value set "
                        f"(body_of / variant_of / fixed geometry) where "
                        f"it is computed, or document the bound with a "
                        f"suppression"))
    return out
