"""The device profiler around a block.

Counterpart of the JAX package's ``utils/profiling.py``: ``device_trace``
wraps ``torch.profiler`` (CPU and CUDA activities) around a block and
writes its Chrome trace to the path given (the JAX package's XProf
directory becomes a trace file here). ``tools/trace_census.py`` reads
it. The request-scoped tracing plane is ``utils/trace.py``; this one is
kernel-scoped.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator


@contextlib.contextmanager
def device_trace(path: str) -> Iterator[object]:
    """Run the block under ``torch.profiler`` (CPU activities, and CUDA
    ones when a card is visible) and write its Chrome trace to ``path``;
    yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)
