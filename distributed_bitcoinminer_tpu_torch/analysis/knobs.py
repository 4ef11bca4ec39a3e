"""Analyzer: DBMT_* knob hygiene (knob-hygiene).

The knob surface is a hundred-odd environment variables; the recurring
rot is threefold and each part is a check here:

1. **Routing.** Every ``DBMT_*`` read must go through the helpers in
   ``utils/_env.py`` (``int_env`` / ``float_env`` / ``str_env``) — one
   grep target for the whole surface, one place for read semantics
   (malformed values fall back silently). Direct ``os.environ.get`` /
   ``os.environ[...]`` / ``os.getenv`` reads of ``DBMT_*`` keys anywhere
   except ``utils/_env.py`` and ``utils/config.py`` are findings.
   Writes (``os.environ["DBMT_X"] = ...``, ``pop``, ``setdefault``,
   child-process env dicts) are not reads and are not flagged.

2. **Docstring sync.** The read knob set (collected from the ``*_env``
   helper calls across the package and ``chip_smoke.py``) must match the
   knob catalog in the ``utils/config.py`` module docstring: every read
   knob documented, no orphaned doc entries. A ``*_env`` call whose knob
   name is not a string literal defeats the collection and is flagged.

3. **README sync.** Same two-way check against the package's own
   ``README.md`` — the knob tables operators actually read. Family
   references like ``DBMT_LEASE_*`` count as covering nothing by
   themselves (each knob must appear exactly somewhere) but are not
   orphans as long as at least one real knob carries the prefix.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Tuple

from .core import Finding, SourceFile, scope_map, str_const

NAME = "knob-hygiene"

ALLOWED_READERS = (
    "distributed_bitcoinminer_tpu_torch/utils/_env.py",
    "distributed_bitcoinminer_tpu_torch/utils/config.py",
)
ENV_HELPERS = ("int_env", "float_env", "str_env")
_TOKEN_RE = re.compile(r"\bDBMT_[A-Z0-9_]+")


def _is_environ(node: ast.AST) -> bool:
    """``os.environ`` (or bare ``environ``)."""
    if isinstance(node, ast.Attribute) and node.attr == "environ":
        return True
    return isinstance(node, ast.Name) and node.id == "environ"


def _direct_reads(tree: ast.AST):
    """(lineno, knob) for each direct environment READ of a DBMT_* key."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            func = node.func
            # os.environ.get("DBMT_X"...) / os.getenv("DBMT_X"...)
            is_get = (isinstance(func, ast.Attribute)
                      and func.attr == "get" and _is_environ(func.value))
            is_getenv = (isinstance(func, ast.Attribute)
                         and func.attr == "getenv")
            if (is_get or is_getenv) and node.args:
                key = str_const(node.args[0])
                if key is not None and key.startswith("DBMT_"):
                    yield node.lineno, key
        elif isinstance(node, ast.Subscript) and \
                isinstance(node.ctx, ast.Load) and _is_environ(node.value):
            key = str_const(node.slice)
            if key is not None and key.startswith("DBMT_"):
                yield node.lineno, key
        elif isinstance(node, ast.Compare) and node.ops and \
                isinstance(node.ops[0], (ast.In, ast.NotIn)) and \
                node.comparators and _is_environ(node.comparators[0]):
            key = str_const(node.left)
            if key is not None and key.startswith("DBMT_"):
                yield node.lineno, key


def _helper_reads(tree: ast.AST):
    """(node, knob_or_None) per ``*_env`` helper call; None = computed."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        fname = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else "")
        if not fname.endswith(ENV_HELPERS):
            continue
        if not node.args:
            continue
        key = str_const(node.args[0])
        if key is None:
            yield node, None
        elif key.startswith("DBMT_"):
            yield node, key


def _doc_tokens(text: str) -> List[str]:
    return _TOKEN_RE.findall(text)


def _coverage(tokens: List[str], knobs: set) -> Tuple[set, List[str]]:
    """(documented_knobs, orphan_tokens) for one document's tokens.

    A token matching a knob exactly documents it. A token that matches
    no knob but is a PREFIX of one (family shorthand like ``DBMT_LEASE_``
    from ``DBMT_LEASE_*``) is not an orphan, but documents nothing.
    """
    documented, orphans = set(), []
    for tok in tokens:
        if tok in knobs:
            documented.add(tok)
        elif any(k.startswith(tok) for k in knobs):
            continue
        else:
            orphans.append(tok)
    return documented, sorted(set(orphans))


def analyze(files: List[SourceFile], repo: str) -> List[Finding]:
    out: List[Finding] = []
    knobs: Dict[str, str] = {}     # knob -> first file that reads it

    for f in files:
        if f.rel.endswith(".sh"):
            for tok in _doc_tokens(f.text):
                knobs.setdefault(tok, f.rel)
            continue
        if f.tree is None:
            continue
        scopes = None
        for node, key in _helper_reads(f.tree):
            if key is None:
                if scopes is None:
                    scopes = scope_map(f.tree)
                scope = scopes.get(id(node)) or "<module>"
                out.append(Finding(
                    NAME, f.rel, node.lineno,
                    f"{NAME}:{f.rel}:computed-knob:{scope}",
                    "env helper called with a computed knob name; the "
                    "knob surface must be greppable (string literal)"))
            else:
                knobs.setdefault(key, f.rel)
        for lineno, key in _direct_reads(f.tree):
            knobs.setdefault(key, f.rel)
            if f.rel in ALLOWED_READERS:
                continue
            out.append(Finding(
                NAME, f.rel, lineno,
                f"{NAME}:{f.rel}:direct-read:{key}",
                f"direct environment read of {key}; route it through "
                f"utils/_env.py (int_env/float_env/str_env) so the knob "
                f"surface stays greppable and malformed values fall "
                f"back silently"))

    # Docstring + README sync (repo-level facts; fixture runs pass a repo
    # without these files and skip the checks).
    config_rel = "distributed_bitcoinminer_tpu_torch/utils/config.py"
    config = next((f for f in files if f.rel == config_rel), None)
    if config is not None and config.tree is not None and knobs:
        doc = ast.get_docstring(config.tree) or ""
        documented, orphans = _coverage(_doc_tokens(doc), set(knobs))
        for knob in sorted(set(knobs) - documented):
            out.append(Finding(
                NAME, config_rel, 1, f"{NAME}:config-doc:{knob}",
                f"knob {knob} (read in {knobs[knob]}) is not documented "
                f"in the utils/config.py module docstring"))
        for tok in orphans:
            out.append(Finding(
                NAME, config_rel, 1, f"{NAME}:config-orphan:{tok}",
                f"utils/config.py docstring documents {tok}, which "
                f"nothing reads — stale doc entry"))

    readme_rel = "distributed_bitcoinminer_tpu_torch/README.md"
    readme = os.path.join(repo, readme_rel)
    if os.path.exists(readme) and knobs and config is not None:
        with open(readme, encoding="utf-8", errors="replace") as fh:
            text = fh.read()
        documented, orphans = _coverage(_doc_tokens(text), set(knobs))
        for knob in sorted(set(knobs) - documented):
            out.append(Finding(
                NAME, readme_rel, 1, f"{NAME}:readme-doc:{knob}",
                f"knob {knob} (read in {knobs[knob]}) does not appear "
                f"anywhere in the package README — add it to a knob "
                f"table"))
        for tok in orphans:
            out.append(Finding(
                NAME, readme_rel, 1, f"{NAME}:readme-orphan:{tok}",
                f"the package README mentions {tok}, which nothing "
                f"reads — stale doc entry"))
    return out
