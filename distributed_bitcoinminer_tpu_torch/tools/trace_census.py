"""The port's device census and trace, the counterpart of the JAX package's
``scripts/trace_mfu.py``.

    python -m distributed_bitcoinminer_tpu_torch.tools.trace_census
        [span_log2] [NAME=VALUE ...]

runs on the first CUDA card and prints one JSON line (``"probe":
"census"``):

1. ``census``: the integer instructions a nonce takes on K1's lane body,
   as given by ``NAME=VALUE`` arguments. ``chip_smoke.py`` passes them
   from its SASS reading of a fixed-shape build of the rates block's tail
   (``sass_int32``, ``sass_fma``, ``sass_other``: the lane loop's
   instructions a nonce by pipe) and from its count of the work a nonce
   needs (``needed_all``, ``needed_int32``, ``needed_rotates``,
   ``needed_pipes``: the busier pipe's share with the rotates placed at
   best). Without arguments the census is empty.
2. ``k1``: one K1 search of ``2^span_log2`` lanes (default 2^29) of the
   10^9 block of "cmu440" from 2 * 10^9, through ``NonceSearcher.search``
   (one K1 launch, its reduce, one K6 fold and one fetch), and ``r3``:
   R3's chain, ``("cmu440", 0, 2^32)`` (the span the system scans for the
   request ``("cmu440", 2^32 - 1)``), each once warm, then once
   under ``torch.profiler`` (CPU and CUDA activities, ``utils.profiling.
   device_trace``). From the profiler's Chrome trace: the device busy time
   of the kernel events (``kernel_ms``, by kernel name), the union of
   every device interval, kernels, copies and sets (``busy_ms``), the
   call's host window (``window_ms``, the call's start to its return,
   the fetch included), the window's IDLE SHARE ``1 - busy_ms /
   window_ms``, the span from the first device event to the last, and
   nonces/s from the kernels' device time.

The profiler's own cost lands in the window: the idle share is an upper
bound on an untraced call's. A profiler that records no device event
fails the tool (exit 1); it does not fall back to another clock. Without
a card it prints nothing and exits 1.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

#: The K1 search's block: "cmu440" with 9 digits from 2 * 10^9 (the tail
#: shape of ``chip_smoke.py``'s one-block rates block).
SPAN_DATA, SPAN_BASE = "cmu440", 2 * 10 ** 9
#: R3: "cmu440" over [0, 2^32] (a request's maxNonce + 1 is scanned
#: too), every digit class up to 10.
R3 = ("cmu440", 0, 1 << 32)
#: Chrome-trace categories of device work.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_intervals(doc: dict) -> list:
    """``(category, name, start_us, end_us)`` of every device event of a
    Chrome trace document."""
    out = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS:
            ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
            out.append((ev["cat"], ev.get("name", ""), ts, ts + dur))
    return out


def union_us(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def traced(fn, tag: str) -> dict:
    """Run ``fn`` once under the device profiler; its answer and the
    device readings of its window."""
    import torch

    from ..utils.profiling import device_trace
    path = os.path.join(tempfile.mkdtemp(prefix="dbmt_census_"),
                        f"{tag}.json")
    torch.cuda.synchronize()
    with device_trace(path):
        t0 = time.perf_counter()
        answer = fn()
        window_ms = (time.perf_counter() - t0) * 1e3
    with open(path) as f:
        events = device_intervals(json.load(f))
    kernels = [e for e in events if e[0] == "kernel"]
    if not kernels:
        raise RuntimeError(f"{tag}: torch.profiler recorded no device "
                           "kernel event")
    by_name: dict = {}
    for _cat, name, a, b in kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
    busy_ms = union_us([(a, b) for _c, _n, a, b in events]) / 1e3
    return {"answer": list(answer), "window_ms": window_ms,
            "kernel_ms": sum(by_name.values()), "kernels": by_name,
            "kernel_events": len(kernels), "device_events": len(events),
            "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / window_ms,
            "device_span_ms": (max(e[3] for e in events)
                               - min(e[2] for e in events)) / 1e3}


def run(span_log2: int, census: dict) -> dict:
    import torch

    from ..models import NonceSearcher
    dev = torch.device("cuda", 0)
    out = {"probe": "census", "card": torch.cuda.get_device_name(dev),
           "census": census}
    s = NonceSearcher(SPAN_DATA, device=dev)
    lanes = 1 << span_log2
    lo, hi = SPAN_BASE, SPAN_BASE + lanes - 1
    r3 = NonceSearcher(R3[0], device=dev)
    for name, searcher, a, b, n in (
            ("k1", s, lo, hi, lanes),
            ("r3", r3, R3[1], R3[2], R3[2] - R3[1] + 1)):
        searcher.search(a, b)                  # warm: build, load, shapes
        rec = traced(lambda: searcher.search(a, b), name)
        rec.update(lanes=n, lower=a, upper=b,
                   nonces_per_s_device=n / (rec["kernel_ms"] / 1e3),
                   nonces_per_s_window=n / (rec["window_ms"] / 1e3))
        out[name] = rec
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import torch
    if not torch.cuda.is_available():
        print("trace_census: no CUDA card", file=sys.stderr)
        return 1
    span_log2, census = 29, {}
    for arg in argv:
        if "=" in arg:
            key, _, value = arg.partition("=")
            census[key] = float(value)
        else:
            span_log2 = int(arg)
    print(json.dumps(run(span_log2, census)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
