"""Per-shard stripe windows of the mesh plane.

Counterpart of the JAX package's ``parallel/partition.py``, cut to
:func:`device_windows`. Its rule table (``MESH_PARTITION_RULES``,
``match_partition_rules``, ``named_tree_map``, ``mesh_specs``) places
operands for ``shard_map`` and has no counterpart here: the replicated
operands of a launch travel by value in its plan, and the sharded ones
are each shard's window words in that plan. ``pow2_subs`` serves only the
pow2-sub mesh chain, which the port does not carry (ROADMAP).
"""

from __future__ import annotations

import numpy as np


def device_windows(lo_i: int, hi_i: int, n_devices: int, batch: int):
    """Per-shard stripe windows: cut the valid lane window ``[lo_i, hi_i]``
    into ``n_devices`` CONTIGUOUS ascending even windows and align each
    shard's scan start down to its ``batch`` boundary.

    Returns ``(i0_d, lo_d, hi_d, steps)``: three ``(n,)`` uint32 arrays
    and the step count of ``batch`` lanes that covers the widest aligned
    window. Trailing shards of a narrow window get an EMPTY window (``lo
    > hi``, ``i0`` 0). The port's kernels take their lane count at run
    time and mask each lane to its window, so the mesh calls this with
    ``batch=1``: each shard then scans ``[lo_d, hi_d]`` exactly.
    """
    span = hi_i - lo_i + 1
    if span <= 0:
        raise ValueError("empty window")
    per = -(-span // n_devices)           # ceil: lanes per shard
    i0_d = np.zeros(n_devices, dtype=np.uint32)
    lo_d = np.ones(n_devices, dtype=np.uint32)
    hi_d = np.zeros(n_devices, dtype=np.uint32)   # lo > hi: empty
    steps = 1
    for d in range(n_devices):
        lo = lo_i + d * per
        if lo > hi_i:
            continue
        hi = min(lo + per - 1, hi_i)
        i0 = (lo // batch) * batch
        lo_d[d] = lo
        hi_d[d] = hi
        i0_d[d] = i0
        steps = max(steps, -(-(hi - i0 + 1) // batch))
    return i0_d, lo_d, hi_d, steps
