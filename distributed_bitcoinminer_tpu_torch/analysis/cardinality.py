"""Analyzer: metric label cardinality (cardinality).

The bug class: a label value derived from an unbounded id
space — conn ids under reconnect churn, job ids, tenant ids — grows one
series per entity until the registry's ``max_series`` bound collapses
REAL traffic into the overflow series. The registry bounds memory, but a
site that churns through the bound is still broken observability.

Rule, per call of ``<registry>.counter/gauge/histogram/ewma`` with label
kwargs (every kwarg except the metric-shape ones ``tau_s``/``buckets``):

- a **literal** label value is bounded by construction — fine;
- a value that is the target of an enclosing comprehension iterating a
  **literal tuple/list** is bounded by that tuple — fine (the
  ``{k: reg.counter("name", outcome=k) for k in ("ok", "exhausted")}``
  hoisted-handle idiom);
- a **dynamic** label value makes the site a per-entity series: the SAME
  module must also contain a ``.remove("<metric>", ...)`` retirement
  call for that metric name (the conn-drop / tenant-GC path), or the
  site needs a ``# dbmlint: ok[cardinality] <why bounded>`` suppression
  stating the boundedness argument (e.g. backoff levels are capped by
  the transport's max-backoff knob).

The metric NAME must be a string literal — a computed name defeats both
this check and snapshot diffing, and is flagged outright.

Trace-track extension: the Perfetto exporter's per-miner /
per-tenant tracks (``utils/trace.TrackSet``) are labeled entities with
the exact same churn failure mode, so ``.track("name", miner=conn_id)``
sites obey the identical rule — a dynamic label needs a same-module
``.retire("name", ...)`` retirement path (miner drop / tenant GC) or a
suppression with the boundedness argument.

Rollup-source extension: the cluster rollup plane keeps
per-source series under a ``proc`` label (one value per publishing
process — unbounded under miner-agent churn, since agents key by pid).
``.proc_series("family", proc=key)`` sites (``apps/rollup.SourceSet``)
obey the same rule with their own retirement method: the module must
also ``.retire_proc("family", ...)`` where a source dies (fence,
long-stale expiry), so churned publishers cycle bound slots instead of
exhausting them.
"""

from __future__ import annotations

import ast
from typing import List

from .core import Finding, SourceFile, scope_map, str_const

NAME = "cardinality"

SCOPE_PREFIX = "distributed_bitcoinminer_tpu_torch/"
REGISTRY_METHODS = {"counter", "gauge", "histogram", "ewma", "track",
                    "proc_series"}
SHAPE_KWARGS = {"tau_s", "buckets"}
#: Which retirement method covers which registration method: metric
#: series retire via ``Registry.remove``, export tracks via
#: ``TrackSet.retire``, rollup per-source series via
#: ``SourceSet.retire_proc`` — a ``.remove`` cannot vouch for a
#: ``.track`` or ``.proc_series`` site or vice versa.
RETIREMENT_FOR = {"counter": "remove", "gauge": "remove",
                  "histogram": "remove", "ewma": "remove",
                  "track": "retire", "proc_series": "retire_proc"}


def _removed_names(tree: ast.AST) -> dict:
    """``retire-method -> {metric names}`` passed to any
    ``.remove("name", ...)`` / ``.retire("name", ...)`` in the file."""
    out: dict = {m: set() for m in set(RETIREMENT_FOR.values())}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in out and node.args:
            name = str_const(node.args[0])
            if name is not None:
                out[node.func.attr].add(name)
    return out


def _comprehension_bounded(tree: ast.AST):
    """call-node id -> names bounded by a literal-iterating enclosing
    comprehension (``for k in ("a", "b")`` makes ``k`` a bounded label
    inside that comprehension's body)."""
    out = {}
    comps = [n for n in ast.walk(tree)
             if isinstance(n, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp))]
    for comp in comps:
        bounded = set()
        for gen in comp.generators:
            if isinstance(gen.iter, (ast.Tuple, ast.List)) and \
                    all(isinstance(el, ast.Constant)
                        for el in gen.iter.elts) and \
                    isinstance(gen.target, ast.Name):
                bounded.add(gen.target.id)
        if not bounded:
            continue
        for sub in ast.walk(comp):
            if isinstance(sub, ast.Call):
                out.setdefault(id(sub), set()).update(bounded)
    return out


def analyze(files: List[SourceFile], repo: str) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        if f.tree is None or not f.rel.startswith(SCOPE_PREFIX):
            continue
        removed = _removed_names(f.tree)
        comp_bounded = _comprehension_bounded(f.tree)
        scopes = None
        for node in ast.walk(f.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in REGISTRY_METHODS):
                continue
            labels = [kw for kw in node.keywords
                      if kw.arg is not None and kw.arg not in SHAPE_KWARGS]
            if not labels:
                continue
            metric = str_const(node.args[0]) if node.args else None
            if metric is None:
                if scopes is None:
                    scopes = scope_map(f.tree)
                scope = scopes.get(id(node)) or "<module>"
                out.append(Finding(
                    NAME, f.rel, node.lineno,
                    f"{NAME}:{f.rel}:computed-name:"
                    f"{node.func.attr}:{scope}",
                    f"labeled .{node.func.attr}() call with a computed "
                    f"metric name; name must be a string literal so the "
                    f"retirement path (and snapshot diffs) can be "
                    f"checked"))
                continue
            bounded_here = comp_bounded.get(id(node), set())
            dynamic = [kw.arg for kw in labels
                       if str_const(kw.value) is None
                       and not (isinstance(kw.value, ast.Name)
                                and kw.value.id in bounded_here)]
            if not dynamic:
                continue
            retire_via = RETIREMENT_FOR[node.func.attr]
            if metric in removed[retire_via]:
                continue   # per-entity series with a retirement path
            out.append(Finding(
                NAME, f.rel, node.lineno,
                f"{NAME}:{f.rel}:{metric}:{'/'.join(sorted(dynamic))}",
                f"metric {metric!r} takes dynamic label(s) "
                f"{sorted(dynamic)} with no .{retire_via}({metric!r}, "
                f"...) retirement path in this module — entity churn "
                f"will exhaust the series bound; retire the series "
                f"where the entity dies, or suppress with the "
                f"boundedness argument"))
    return out
