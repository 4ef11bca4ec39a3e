"""dbmlint core: source loading, finding identity, baseline mechanics.

Design constraints:

1. **No torch, no imports of the analyzed code.** Everything is ``ast``
   + text, so the lint runs in seconds on a box without a card (and
   without building a kernel — the ~50 s ``nvcc`` run the loop-block and
   build-static analyzers exist to keep off the serving path).
2. **Stable finding identity.** A finding's ``key`` carries no line
   number — baselines must survive unrelated edits above a finding —
   only (analyzer, file, enclosing symbol, short code). Line numbers
   ride along for display.
3. **Monotonic baseline.** New keys fail the run; keys that disappear
   are flushed by ``--update-baseline``; growing the baseline requires
   an explicit ``--force`` (the escape hatch for deliberately deferred
   findings, which should be rare — prefer a ``# dbmlint: ok[...]``
   suppression WITH a justification at the site).
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

#: Suppression marker: ``# dbmlint: ok[analyzer] why`` (analyzer optional:
#: a bare ``# dbmlint: ok`` suppresses every analyzer on that line).
_OK_RE = re.compile(r"#\s*dbmlint:\s*ok(?:\[([a-z-]+)\])?")


@dataclass(frozen=True)
class Finding:
    analyzer: str
    path: str          # repo-relative, forward slashes
    line: int
    key: str           # stable identity (no line number)
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.analyzer}] {self.message}"


@dataclass
class SourceFile:
    """One analyzed file: text + (for .py) its parsed AST."""
    path: str                    # absolute
    rel: str                     # repo-relative, forward slashes
    text: str
    tree: Optional[ast.AST] = None
    _ok_lines: Optional[Dict[int, Optional[str]]] = field(
        default=None, repr=False)

    @property
    def lines(self) -> List[str]:
        return self.text.splitlines()

    def suppressed(self, line: int, analyzer: str) -> bool:
        """True when ``line`` carries a matching ``# dbmlint: ok`` marker."""
        if self._ok_lines is None:
            table: Dict[int, Optional[str]] = {}
            for i, ln in enumerate(self.lines, 1):
                m = _OK_RE.search(ln)
                if m:
                    table[i] = m.group(1)
            self._ok_lines = table
        if line not in self._ok_lines:
            return False
        which = self._ok_lines[line]
        return which is None or which == analyzer


PACKAGE = "distributed_bitcoinminer_tpu_torch"

#: Files scanned beyond the package: the root smoke script, which reads
#: ``DBMT_*`` knobs too. The port's tools live in the package, so it has
#: no ``bench.py`` or ``scripts/`` of its own.
EXTRA_PY = ("chip_smoke.py",)


def load_files(repo: str) -> List[SourceFile]:
    """Every analyzed source file, parsed. Syntax errors become findings
    at run time rather than crashes (a lint gate must report, not die)."""
    out: List[SourceFile] = []
    roots = [os.path.join(repo, PACKAGE)]
    for root in roots:
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            for name in sorted(filenames):
                if name.endswith(".py"):
                    out.append(_load_py(repo, os.path.join(dirpath, name)))
    for rel in EXTRA_PY:
        path = os.path.join(repo, rel)
        if os.path.exists(path):
            out.append(_load_py(repo, path))
    return out


def _rel(repo: str, path: str) -> str:
    return os.path.relpath(path, repo).replace(os.sep, "/")


def _read(path: str) -> str:
    with open(path, encoding="utf-8", errors="replace") as f:
        return f.read()


def _load_py(repo: str, path: str) -> SourceFile:
    text = _read(path)
    try:
        tree = ast.parse(text)
    except SyntaxError:
        tree = None
    return SourceFile(path=path, rel=_rel(repo, path), text=text, tree=tree)


def _analyzers():
    # Imported inside the function: the analyzer modules import
    # Finding/SourceFile from THIS module, so the catalog can only be
    # built once core's classes exist (the call at module bottom runs
    # after every definition above it).
    from . import (buildstatic, cardinality, hotpathalloc, knobs,
                   lockdiscipline, loopblock, threadstate)
    return {
        "loop-block": loopblock.analyze,
        "cardinality": cardinality.analyze,
        "knob-hygiene": knobs.analyze,
        "build-static": buildstatic.analyze,
        "thread-state": threadstate.analyze,
        "lock-discipline": lockdiscipline.analyze,
        "hotpath-alloc": hotpathalloc.analyze,
    }


def run_repo(repo: str, only: Optional[str] = None) -> List[Finding]:
    """Run every analyzer (or ``only``) over the repo; suppressions and
    syntax-error findings applied here, sorted stably."""
    files = load_files(repo)
    findings: List[Finding] = []
    for f in files:
        if f.rel.endswith(".py") and f.tree is None:
            findings.append(Finding(
                "parse", f.rel, 1, f"parse:{f.rel}",
                "file does not parse; analyzers skipped it"))
    for name, fn in ANALYZERS.items():
        if only is not None and name != only:
            continue
        findings.extend(fn(files, repo))
    by_file = {f.rel: f for f in files}
    kept = []
    seen = set()
    for fd in findings:
        src = by_file.get(fd.path)
        if src is not None and src.suppressed(fd.line, fd.analyzer):
            continue
        if fd.key in seen:
            continue
        seen.add(fd.key)
        kept.append(fd)
    kept.sort(key=lambda fd: (fd.path, fd.line, fd.analyzer, fd.key))
    return kept


def run_source(analyzer: str, source: str,
               rel: str = "distributed_bitcoinminer_tpu_torch/apps/_fixture.py",
               repo: str = ".") -> List[Finding]:
    """Run ONE analyzer over an in-memory snippet (fixture tests).

    ``rel`` places the snippet inside the tree (analyzers scope by
    path); suppression comments apply like anywhere else.
    """
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return [Finding("parse", rel, 1, f"parse:{rel}", "does not parse")]
    f = SourceFile(path=rel, rel=rel, text=source, tree=tree)
    found = ANALYZERS[analyzer]([f], repo)
    return [fd for fd in found if not f.suppressed(fd.line, fd.analyzer)]


# ----------------------------------------------------------------- baseline

def baseline_path(repo: str) -> str:
    return os.path.join(repo, PACKAGE, "analysis", "baseline.json")


def load_baseline(path: str) -> Dict[str, str]:
    """key -> message of the checked-in accepted findings."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return dict(data.get("findings", {}))


def save_baseline(path: str, findings: List[Finding]) -> None:
    payload = {
        "comment": "dbmlint accepted-findings baseline. New findings "
                   "FAIL the lint; this file may only shrink "
                   "(--update-baseline flushes fixed entries; growing "
                   "it needs --force).",
        "findings": {f.key: f.message for f in
                     sorted(findings, key=lambda f: f.key)},
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")


def compare(findings: List[Finding], baseline: Dict[str, str]):
    """(new, known, stale_keys): findings not in the baseline, findings
    covered by it, and baseline keys that no longer fire."""
    keys = {f.key for f in findings}
    new = [f for f in findings if f.key not in baseline]
    known = [f for f in findings if f.key in baseline]
    stale = sorted(k for k in baseline if k not in keys)
    return new, known, stale


# ------------------------------------------------------------ AST helpers

def dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a call target (``a.b.c`` -> "a.b.c")."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif isinstance(node, ast.Call):
        parts.append(dotted(node.func) + "()")
    else:
        parts.append("?")
    return ".".join(reversed(parts))


def direct_body(nodes):
    """Walk statements without descending into nested function/lambda
    definitions (their bodies execute elsewhere: a thread pool, a later
    call)."""
    stack = list(nodes)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def scope_map(tree: ast.AST) -> Dict[int, str]:
    """``id(node) -> dotted enclosing scope`` ("Cls.meth"; "" = module).

    Finding keys for sites with no better identity (computed metric or
    knob names) key on the enclosing scope instead of the line number,
    honoring the stable-identity contract (design constraint #2)."""
    out: Dict[int, str] = {}

    def visit(node: ast.AST, scope: str) -> None:
        for child in ast.iter_child_nodes(node):
            s = scope
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                s = f"{scope}.{child.name}" if scope else child.name
            out[id(child)] = s
            visit(child, s)

    visit(tree, "")
    return out


#: Analyzer name -> callable(files, repo) — the public catalog.
ANALYZERS = _analyzers()
