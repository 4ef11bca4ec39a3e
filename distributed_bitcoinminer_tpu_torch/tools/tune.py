"""The port's on-chip tuning tool, the counterpart of the JAX package's
``scripts/tpu_tune.py``.

    python -m distributed_bitcoinminer_tpu_torch.tools.tune [span_log2]
        [NAME=INT32_PER_LANE ...]

(default span 2^24) runs on the first CUDA card and prints four JSON
lines:

1. ``K7``: the INT32 ALU ceiling. The probe kernel (``ops.alu_probe``) at
   full occupancy for at least 10 ms a launch: the nominal rate by the TPU
   script's count (48 operations an iteration), the instructions of its
   SASS loop body (one iteration: the rotate is one funnel shift on
   Hopper, so 48 operations are not 48 instructions), the instructions
   issued per SM per clock at the SM clock measured during the run beside
   the 128 an SM can issue and the 64 lanes of its INT32 pipe, the INT32
   instructions the card issued a second, and for each ``NAME=N``
   argument (a kernel whose lane loop issues N INT32 instructions a nonce,
   as ``chip_smoke.py``'s rates phase reads them from the SASS) the
   nonce/s ceiling that rate implies;
2. ``grid_sweep``: K1 over a ``2^span_log2`` span of one 10^9 block at 1,
   2, 3 and 4 resident blocks per SM, up to its maximum (the rows sweep's
   counterpart);
3. ``kernel_vs_plain``: K1 at its default grid and its plain scan over that
   span (the tier waterfall's counterpart);
4. ``until``: K2 over that span with a target that nothing meets, and
   with the all-ones target, which lane 0 meets.

Times are CUDA-event milliseconds, means over several launches after a
warm-up. Without a card it prints nothing and exits 1.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys

#: Instructions one Hopper SM issues a clock (four schedulers, one warp
#: instruction each), and the lanes its INT32 pipe takes a clock.
RATE_ISSUE_PER_CLK_PER_SM = 128
RATE_INT32_PER_CLK_PER_SM = 64
#: SASS opcodes that do not issue to the INT32 pipe: the integer ops of
#: the FMA pipe (IMAD, and Hopper's VIADD, which the compiler emits to
#: move adds off the INT32 pipe), memory and constant loads, control
#: flow, and uniform-datapath ops. K7 itself checks the split: at most 64
#: of the instructions it counts as INT32 can issue per SM per clock
#: (``int32_fits_pipe``).
NON_INT32_PREFIXES = ("IMAD", "VIADD", "LD", "ST", "BRA", "BSSY", "BSYNC",
                      "EXIT", "BAR", "NOP", "S2R", "S2UR", "CS2R", "SHFL",
                      "WARPSYNC", "RET", "CALL", "U")
#: The least time of one probe launch, so that launch costs do not count.
MIN_PROBE_MS = 10.0
#: The least time of the timed probe launches, so that the SM clock is
#: sampled several times.
MIN_CLOCKED_MS = 500.0
#: The span's block: "cmu440" with 9 digits from 2 * 10^9, a 1-block tail.
SPAN_DATA, SPAN_BASE = "cmu440", 2 * 10 ** 9


def _cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found")


def sass_loops(lib: str, kernel: str) -> tuple:
    """The SASS of the first function of ``lib`` whose mangled name holds
    ``kernel`` (``cuobjdump -sass``): ``(its text, its loops, the
    function's instruction count)``; a loop is ``(first address, last
    address, its instructions)`` for each backward branch, NOPs left
    out."""
    out = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump: {out.stderr.strip()}")
    funcs = re.split(r"\n\s*Function : ", out.stdout)
    body = next((f for f in funcs[1:] if kernel in f.splitlines()[0]), None)
    if body is None:
        raise RuntimeError(f"no SASS for {kernel} in {lib}")
    insns, labels, pending = [], {}, []
    for line in body.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            insns.append((addr, m.group(2)))
    loops = []
    for addr, text in insns:
        m = re.search(r"BRA\s+(?:`\()?(\.L_x_\d+|0x[0-9a-f]+)", text)
        if not m:
            continue
        tgt = m.group(1)
        tgt = int(tgt, 16) if tgt.startswith("0x") else labels.get(tgt)
        if tgt is not None and tgt < addr:
            loops.append((tgt, addr, [t for a, t in insns if tgt <= a <= addr
                                      and not t.split()[0].endswith("NOP")]))
    if not loops:
        raise RuntimeError(f"no backward branch in {kernel}'s SASS")
    return body, loops, len(insns)


def sass_loop(lib: str, kernel: str) -> tuple:
    """``(SASS text, the instructions of the widest backward branch's loop,
    the function's instruction count)`` (see :func:`sass_loops`)."""
    body, loops, total = sass_loops(lib, kernel)
    return body, max(loops, key=lambda lp: lp[1] - lp[0])[2], total


def opcode_counts(insns: list) -> dict:
    """``{opcode: count}`` of SASS instruction texts (predicates dropped)."""
    ops = {}
    for t in insns:
        op = re.match(r"(?:@!?U?P[T0-9]\s+)?([A-Z0-9_]+)", t).group(1)
        ops[op] = ops.get(op, 0) + 1
    return ops


def int32_count(ops: dict) -> int:
    """The instructions of ``ops`` that issue to the INT32 pipe."""
    return sum(n for op, n in ops.items()
               if not op.startswith(NON_INT32_PREFIXES))


#: SASS opcodes of the FMA pipe's integer work.
FMA_PREFIXES = ("IMAD", "VIADD")


def pipe_counts(ops: dict) -> dict:
    """``ops`` by pipe: ``int32`` (:func:`int32_count`), ``fma`` (IMAD,
    VIADD), ``other`` (memory, control, uniform) and ``all``."""
    int32 = int32_count(ops)
    fma = sum(n for op, n in ops.items() if op.startswith(FMA_PREFIXES))
    total = sum(ops.values())
    return {"int32": int32, "fma": fma, "other": total - int32 - fma,
            "all": total}


def events_ms(fn, reps: int) -> float:
    """Mean CUDA-event milliseconds of ``fn`` over ``reps`` runs after one
    warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


class SmClock:
    """``nvidia-smi``'s SM clock (MHz) every 50 ms while the ``with`` block
    runs; ``mhz`` is the median after the first quarter. Entering waits
    for the first sample, so a block shorter than ``nvidia-smi``'s start
    is still sampled."""

    def __enter__(self):
        self._proc = subprocess.Popen(
            [shutil.which("nvidia-smi") or "nvidia-smi",
             "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
             "-lms", "50"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        self._first = self._proc.stdout.readline()
        return self

    def __exit__(self, *exc):
        self._proc.terminate()
        out, _ = self._proc.communicate(timeout=20)
        vals = [float(x) for x in (self._first + out).split()
                if x.replace(".", "").isdigit()]
        self.samples = vals[len(vals) // 4:]
        self.mhz = statistics.median(self.samples) if self.samples else None
        return False


def probe_k7(dev, int32_per_lane: dict) -> dict:
    """K7 at full occupancy for at least :data:`MIN_PROBE_MS` a launch;
    ``int32_per_lane`` maps a kernel's name to its lane loop's INT32
    instructions a nonce, for the nonce/s ceilings."""
    import torch

    from ..ops import alu_probe
    wave, threads = alu_probe.wave(dev), alu_probe.threads()
    one = events_ms(lambda: alu_probe.alu_probe(wave, device=dev), 3)
    waves = max(1, math.ceil(1.2 * MIN_PROBE_MS / one))
    grid = wave * waves
    reps = max(10, math.ceil(MIN_CLOCKED_MS / (one * waves)))
    with SmClock() as clock:
        ms = events_ms(lambda: alu_probe.alu_probe(grid, device=dev), reps)
    if clock.mhz is None:
        raise RuntimeError("K7: nvidia-smi gave no SM clock sample")
    _, loop, _ = sass_loop(alu_probe.LIBRARY, "alu_probe_kernel")
    ops = opcode_counts(loop)
    lanes, iters = grid * threads, alu_probe.ITERS
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clk_hz = clock.mhz * 1e6
    per_clk = lanes * iters / (ms / 1e3) / (sms * clk_hz)
    issued, int32 = per_clk * len(loop), per_clk * int32_count(ops)
    int32_per_s = int32 * sms * clk_hz
    return {"probe": "K7", "device": torch.cuda.get_device_name(dev),
            "grid": grid, "waves": waves, "threads": threads,
            "reps": reps,
            "lanes": lanes, "iters": iters, "ms": ms,
            "nominal_ops_per_s": lanes * iters * alu_probe.OPS_PER_ITER
            / (ms / 1e3),
            "sass_insns_per_iter": len(loop),
            "sass_int32_insns_per_iter": int32_count(ops),
            "sass_loop_ops": ops, "sm_clock_mhz": clock.mhz,
            "issued_per_clk_per_sm": issued,
            "issue_share": issued / RATE_ISSUE_PER_CLK_PER_SM,
            "int32_per_clk_per_sm": int32,
            "int32_share": int32 / RATE_INT32_PER_CLK_PER_SM,
            "int32_fits_pipe": int32 <= RATE_INT32_PER_CLK_PER_SM,
            "int32_insns_per_s": int32_per_s,
            "ceiling_nonces_per_s": {
                kern: int32_per_s / n for kern, n in int32_per_lane.items()},
            "ceiling_int32_per_lane": int32_per_lane,
            "launches": alu_probe.launches["K7"]}


def _span_plan(dev, span: int):
    from ..models import NonceSearcher
    (p,) = list(NonceSearcher(SPAN_DATA, device=dev).plan(
        SPAN_BASE, SPAN_BASE + span - 1))
    return p


def grid_sweep(dev, span: int) -> dict:
    """K1 over the span at 1..4 resident blocks per SM (up to its most)."""
    import torch

    from ..ops import sha256_cuda
    p = _span_plan(dev, span)
    most = sha256_cuda.load().dbmt_sha256_blocks_per_sm(
        sha256_cuda.ENTRY_ARGMIN, 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for per_sm in range(1, min(4, most) + 1):
        ms = events_ms(lambda: sha256_cuda.sha256_argmin(
            p.midstate, p.template, p.lo_i, p.lo_i, p.hi_i, p.lanes,
            rem=p.rem, k=p.k, device=dev, grid=sms * per_sm), 5)
        rows.append({"blocks_per_sm": per_sm, "grid": sms * per_sm,
                     "ms": ms, "nonces_per_s": span / (ms / 1e3)})
    return {"probe": "grid_sweep", "span": span, "max_blocks_per_sm": most,
            "rows": rows}


def kernel_vs_plain(dev, span: int) -> dict:
    """K1 at its default grid and its plain scan over the span."""
    from ..ops import search, sha256_cuda
    p = _span_plan(dev, span)
    args = (p.midstate, p.template, p.lo_i, p.lo_i, p.hi_i, p.lanes)
    kw = dict(rem=p.rem, k=p.k, device=dev)
    k1 = sha256_cuda.sha256_argmin(*args, **kw)
    plain = search.span_scan(*args, **kw)
    if [int(x) & 0xFFFFFFFF for x in k1.tolist()] != plain.tolist():
        raise RuntimeError("K1 disagrees with its plain scan")
    ms = events_ms(lambda: sha256_cuda.sha256_argmin(*args, **kw), 5)
    plain_ms = events_ms(lambda: search.span_scan(*args, **kw), 1)
    return {"probe": "kernel_vs_plain", "span": span, "k1_ms": ms,
            "k1_nonces_per_s": span / (ms / 1e3), "plain_ms": plain_ms,
            "plain_nonces_per_s": span / (plain_ms / 1e3)}


def until(dev, span: int) -> dict:
    """K2 over the span with a target nothing meets and with the all-ones
    target, which lane 0 meets."""
    from ..ops import sha256_cuda
    p = _span_plan(dev, span)
    args = (p.midstate, p.template, p.lo_i, p.lo_i, p.hi_i, p.lanes)
    kw = dict(rem=p.rem, k=p.k, device=dev)
    out = {"probe": "until", "span": span}
    for name, t in (("miss", 0), ("hit_lane0", (1 << 64) - 1)):
        found, f_idx = (int(x) & 0xFFFFFFFF for x in sha256_cuda.sha256_until(
            *args, t >> 32, t & 0xFFFFFFFF, **kw)[:2].tolist())
        if (found, f_idx) != ((0, 0xFFFFFFFF) if t == 0 else (1, 0)):
            raise RuntimeError(f"K2 {name}: found {found} at {f_idx}")
        out[f"{name}_ms"] = events_ms(lambda: sha256_cuda.sha256_until(
            *args, t >> 32, t & 0xFFFFFFFF, **kw), 5)
    out["miss_nonces_per_s"] = span / (out["miss_ms"] / 1e3)
    return out


def main(argv=None) -> int:
    import torch
    argv = sys.argv[1:] if argv is None else argv
    counts = dict(a.split("=", 1) for a in argv if "=" in a)
    rest = [a for a in argv if "=" not in a]
    span = 1 << (int(rest[0]) if rest else 24)
    if not torch.cuda.is_available():
        print("tune: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    for line in (probe_k7(dev, {k: float(n) for k, n in counts.items()}),
                 grid_sweep(dev, span),
                 kernel_vs_plain(dev, span), until(dev, span)):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
