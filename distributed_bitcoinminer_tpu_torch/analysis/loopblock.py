"""Analyzer: blocking calls inside ``async def`` bodies (loop-block).

The bug class: synchronous device or subprocess work executed directly
on the asyncio event loop starves the LSP engine's heartbeat/ack timers
— a miner stuck in a kernel build or a long ``subprocess.run`` passes
its transport's epoch check late or never and gets declared dead while
healthy. Every compute call must hop to a worker thread
(``asyncio.to_thread`` / ``run_in_executor``).

Scope: ``apps/`` and ``lsp/`` (the asyncio actors). The walk covers the
DIRECT body of each ``async def`` — nested ``def``/``lambda`` bodies run
wherever they are later called (usually a thread pool), so only the
statements the coroutine itself executes are charged to the loop.

What counts as blocking (curated for the port's own surface, not a
general list):

- ``time.sleep`` (the asyncio one is fine);
- subprocess execution (``subprocess.run/check_*/call``, ``os.system``);
- forcing a device result: ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.synchronize()``, ``torch.cuda.synchronize``,
  ``np.asarray``;
- the kernel builds and loads: ``sha256_cuda.build`` / ``build_all`` /
  ``load`` (an ``nvcc`` run — about 50 s on the H100's host),
  ``sha256_native.build`` / ``load`` (the host tier's ``g++`` build)
  and ``alu_probe.build`` / ``load``;
- searcher construction and probing: ``default_searcher_factory``,
  ``NonceSearcher``, ``MeshNonceSearcher``, ``PodSearcher``,
  ``HostSearcher``, ``run_follower``, ``measure_rate_hint``,
  ``warm_up`` / ``warm_up_mesh`` (each builds or launches kernels);
- the searcher compute surface: ``.search()``, ``.search_until()``,
  ``.dispatch()``, ``.finalize()``, ``.dispatch_batch()``,
  ``.finalize_batch()`` (a dispatch can hide a kernel build), the
  miner's resolve helpers (``_get_searcher``, ``_search``,
  ``_resolve_and_dispatch``, ``_resolve_and_dispatch_batch``) and the
  native scans ``scan_min_native`` / ``scan_until_native``.
"""

from __future__ import annotations

import ast
from typing import List

from .core import Finding, SourceFile, direct_body, dotted

NAME = "loop-block"

SCOPE_PREFIXES = (
    "distributed_bitcoinminer_tpu_torch/apps/",
    "distributed_bitcoinminer_tpu_torch/lsp/",
)

#: Exact dotted names that block (matched against the call's dotted
#: form, so ``time.sleep`` hits ``time.sleep(...)`` and an aliased
#: ``t.sleep`` only when spelled with the module name).
BLOCKING_DOTTED = {
    "time.sleep", "subprocess.run", "subprocess.check_output",
    "subprocess.check_call", "subprocess.call", "os.system",
    "np.asarray", "numpy.asarray", "torch.cuda.synchronize",
    "sha256_cuda.build", "sha256_cuda.build_all", "sha256_cuda.load",
    "sha256_native.build", "sha256_native.load",
    "alu_probe.build", "alu_probe.load",
}

#: Bare function / constructor names that block regardless of receiver.
BLOCKING_NAMES = {
    "default_searcher_factory", "NonceSearcher", "MeshNonceSearcher",
    "PodSearcher", "HostSearcher", "run_follower", "measure_rate_hint",
    "warm_up", "warm_up_mesh", "scan_min_native", "scan_until_native",
}

#: Method names that block on ANY receiver (the compute surface and the
#: device-result forcing calls).
BLOCKING_ATTRS = {
    "item", "tolist", "cpu", "numpy", "synchronize",
    "search", "search_until", "dispatch", "finalize", "dispatch_batch",
    "finalize_batch", "_get_searcher", "_search",
    "_resolve_and_dispatch", "_resolve_and_dispatch_batch",
}

#: Generic method names that stay attribute-only (a bare ``search(...)``
#: is some local helper, not the compute surface).
_ATTR_ONLY = {"item", "tolist", "cpu", "numpy", "synchronize", "search",
              "search_until", "dispatch", "finalize", "dispatch_batch",
              "finalize_batch"}


def _blocking_reason(call: ast.Call):
    func = call.func
    name = dotted(func)
    if name in BLOCKING_DOTTED:
        return f"call to {name}"
    if isinstance(func, ast.Name) and func.id in BLOCKING_NAMES:
        return f"call to {func.id} (kernel build/searcher construction)"
    if isinstance(func, ast.Attribute) and func.attr in BLOCKING_ATTRS:
        # `self.foo.item` etc. — attribute on any receiver.
        if isinstance(func.value, ast.Name) and \
                func.value.id == "asyncio":
            return None   # asyncio.sleep etc.
        return f"call to .{func.attr}() (blocking compute surface)"
    if isinstance(func, ast.Name) and func.id in BLOCKING_ATTRS and \
            func.id not in _ATTR_ONLY:
        # Bare-name forms of the repo helpers (imported unqualified); the
        # generic method names stay attribute-only to avoid false hits.
        return f"call to {func.id} (blocking compute surface)"
    return None


def analyze(files: List[SourceFile], repo: str) -> List[Finding]:
    out: List[Finding] = []
    for f in files:
        if f.tree is None or not f.rel.startswith(SCOPE_PREFIXES):
            continue
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.AsyncFunctionDef):
                continue
            # Only the statements the coroutine itself executes.
            for sub in direct_body(node.body):
                if not isinstance(sub, ast.Call):
                    continue
                reason = _blocking_reason(sub)
                if reason is None:
                    continue
                callee = dotted(sub.func)
                out.append(Finding(
                    NAME, f.rel, sub.lineno,
                    f"{NAME}:{f.rel}:{node.name}:{callee}",
                    f"async def {node.name} runs blocking {reason} on "
                    f"the event loop; hop to a worker thread "
                    f"(asyncio.to_thread) so LSP heartbeats keep "
                    f"flowing"))
    return out
