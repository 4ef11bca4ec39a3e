"""Analyzer: allocation churn on marked hot paths (hotpath-alloc).

The bug class: the transport datapath runs per packet —
millions of times a second at production rates — and its fast paths
(``lsp/wire.py``'s codec, the core's receive path) were specifically
rebuilt to avoid the json/base64 module round-trips and per-call dict
churn the stock codec pays. A later "harmless" edit that reintroduces
``json.dumps`` or a dict literal into one of those functions silently
costs the fast codec's gain — and nothing structural stops it, because
the slow idioms are perfectly correct.

Rule: inside any function whose ``def`` is marked with a
``# dbmlint: hotpath`` comment (on the def line or the line directly
above it), flag

- calls to ``json.dumps`` / ``json.loads``,
- calls into the ``base64`` module (``base64.b64encode`` etc. —
  ``binascii`` is the sanctioned zero-copy primitive),
- dict and list display literals (``{...}`` / ``[...]``), each an
  allocation per packet; comprehensions feeding them are flagged via
  the display node they build.

Scope: ``lsp/`` only — the marker is a per-function opt-in, so the
analyzer stays silent everywhere a function isn't explicitly declared
hot. Nested ``def``/``lambda`` bodies inside a marked function are NOT
exempt: code defined on the hot path runs on the hot path. Knob-off
fallback branches that delegate to the stock codec (``Message.to_json``
/ ``from_json``) are method calls, not module calls, so they pass —
by design, the slow path lives in ``message.py``, unmarked.

Suppress a deliberate exception with ``# dbmlint: ok[hotpath-alloc]``
and the argument why the allocation is off the per-packet path.
"""

from __future__ import annotations

import ast
import re
from typing import List

from .core import Finding, SourceFile, dotted, scope_map

NAME = "hotpath-alloc"

SCOPE_PREFIX = "distributed_bitcoinminer_tpu_torch/lsp/"

_MARK_RE = re.compile(r"#\s*dbmlint:\s*hotpath\b")

#: Exact dotted call targets that are never acceptable per packet.
BANNED_DOTTED = {"json.dumps", "json.loads"}
#: Module prefix: any call into base64 (the C-level binascii functions
#: are the fast alternative the wire codec uses).
BANNED_PREFIX = "base64."


def _marked_functions(f: SourceFile) -> List[ast.AST]:
    """FunctionDefs whose header carries (or directly follows) the
    ``# dbmlint: hotpath`` marker."""
    marks = {i for i, ln in enumerate(f.lines, 1) if _MARK_RE.search(ln)}
    if not marks:
        return []
    out = []
    for node in ast.walk(f.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        header = min([node.lineno] +
                     [d.lineno for d in node.decorator_list])
        if header in marks or header - 1 in marks:
            out.append(node)
    return out


def _violations(fn: ast.AST):
    """(node, code, what) for each banned construct in the function."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            name = dotted(node.func)
            if name in BANNED_DOTTED:
                yield node, name, f"call to {name}"
            elif name.startswith(BANNED_PREFIX):
                yield (node, name,
                       f"call to {name} (use binascii primitives)")
        elif isinstance(node, ast.Dict):
            yield node, "dict-literal", "dict literal"
        elif isinstance(node, ast.List):
            yield node, "list-literal", "list literal"


def analyze(files: List[SourceFile], repo: str) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        if f.tree is None or not f.rel.startswith(SCOPE_PREFIX):
            continue
        marked = _marked_functions(f)
        if not marked:
            continue
        scopes = scope_map(f.tree)
        for fn in marked:
            fn_scope = scopes.get(id(fn)) or "<module>"
            seen_codes = {}
            for node, code, what in _violations(fn):
                # One finding per (function, construct kind): stable
                # identity without line numbers, and a second dict
                # literal in the same function is the same defect.
                n = seen_codes.setdefault(code, node)
                if n is not node:
                    continue
                out.append(Finding(
                    NAME, f.rel, node.lineno,
                    f"{NAME}:{f.rel}:{fn_scope}:{code}",
                    f"{what} inside hotpath-marked function "
                    f"{fn_scope}(): this code runs per packet — use the "
                    f"wire codec's allocation-free idioms, or move the "
                    f"work off the datapath"))
    return out
