"""dbmlint — the port's own AST-based invariant checker.

It machine-checks the bug classes reviews kept re-finding by hand. Pure
AST + text over the working tree: importing it (and running every
analyzer) imports neither torch nor the analyzed code, so the lint
costs seconds, not a device init or a kernel build.

Analyzers (each a module exporting ``analyze(files, repo) -> [Finding]``):

- ``loopblock`` — blocking calls (device-result forcing, kernel builds,
  subprocess, sleeps, searcher construction/scans) reachable from
  ``async def`` bodies in ``apps/`` and ``lsp/`` without a thread-pool
  hop.
- ``cardinality`` — dynamic metric label values must have a retirement
  path (a matching ``.remove(...)`` in the same module) or a justified
  suppression, so conn/job/tenant churn can't grow series without bound.
- ``knobs`` — every ``DBMT_*`` read routes through ``utils/_env.py`` /
  ``utils/config.py``; the read knob set, the ``utils/config.py``
  docstring, and the package README's knob tables must all agree (no
  undocumented knobs, no orphaned doc entries).
- ``buildstatic`` — runtime-derived values at a kernel build boundary
  (the ``nvcc`` build of a lane body's library, the host tier's and the
  probe's builds) in ``ops/``, ``models/``, ``parallel/``, ``apps/``.
- ``threadstate`` — attributes of ``Scheduler`` / ``QosPlane`` /
  ``MinerWorker`` touched from both coroutines and worker threads must
  appear in the class's ``THREAD_SHARED`` ownership table or be mutated
  under a lock.
- ``lockdiscipline`` — a sync lock held across an ``await``, or a
  blocking call under any lock, in ``apps/`` and ``lsp/``.
- ``hotpathalloc`` — allocations and codec round-trips inside functions
  marked ``# dbmlint: hotpath`` in ``lsp/``.

Workflow: ``python -m distributed_bitcoinminer_tpu_torch.tools.dbmlint``
checks the tree against the checked-in baseline (``analysis/baseline.json``).
NEW findings fail the run; fixed findings leave stale baseline entries,
flushed with ``--update-baseline`` — which refuses to GROW the baseline
unless ``--force`` is given, so the baseline shrinks monotonically.
Line-targeted suppressions use ``# dbmlint: ok[<analyzer>] <why>``.
"""

from .core import (ANALYZERS, Finding, baseline_path, compare, load_baseline,
                   load_files, run_repo, run_source, save_baseline)

__all__ = ["ANALYZERS", "Finding", "baseline_path", "compare",
           "load_baseline", "load_files", "run_repo", "run_source",
           "save_baseline"]
