#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port: build, kernel checks, end to end, rates.

    python3 chip_smoke.py                # every phase, on one CUDA card
    python3 chip_smoke.py --cross-card   # the mesh, and a pod of one
                                         # rank a card with its
                                         # follower-death drill, over
                                         # every card of a box with
                                         # several
    python3 chip_smoke.py --chaos-storm SEED   # the chaos path's worker
    python3 chip_smoke.py --against CHECKOUT
        # the build and kernel checks, then this package against the one
        # in CHECKOUT (another commit's tree, e.g. the parent's from
        # `git archive`), each through its own wrappers in a process of
        # its own, in turns (against())

Drives ``distributed_bitcoinminer_tpu_torch`` on the card and prints one
JSON line per phase:

1. device: the card's name, CUDA version, and ``nvidia-smi``'s name and
   power limit (also printed raw on a line of its own);
2. build: compiles the three lane bodies' libraries with nvcc (sm_90a;
   rolled, K3's peel, K4's peel fed by the host hoist) and K7's, one nvcc
   each, all at once, beside the SASS-reading builds of the peeled bodies
   (the shapes of the rates blocks fixed at compile time); reports each
   kernel's registers and spills and its resident blocks per SM;
3. kernel: each kernel against its plain PyTorch version on the card, over
   rem x k in {0,1,3,4,31,32,55,56,62,63} x {1,5,9} (1- and 2-block
   tails), windows whose valid edges fall off thread, block and run
   edges, and six windows that cut runs of lanes at both ends or are
   shorter than one run (``CUT_RUN_WINDOWS``). K1
   (arg-min): triples bit-identical, each winner hashing to its triple
   under hashlib. K2 (difficulty target): three targets per case, one
   hitting at the window's arg-min lane, one that half the lanes satisfy
   (run at the default grid and at 37 blocks: the first qualifying lane
   must win the race at both), one that nothing satisfies; found and f_idx
   equal always, the arg-min words when found is 0. K6 (device-resident
   chain): arg-min and until chains of 4 blocks past 2^32, the until chain
   hitting in its third block, carry words equal after every block (the
   arg-min words until the hit), and the launch after the hit leaving the
   carry untouched. K5 (batched segment-min): one batch of rows over four
   messages (1- and 2-block tails), digit classes 1-9, ragged windows, a
   three-row segment, a row of each 2-block tail shape and empty-window
   rows (every tail shape among them, and among K2's windows, which hold
   a 2^18-lane window of each 2-block shape), word for word against
   ``span_segmin_scan`` at the default grid and at 37 blocks; and the
   searcher's batched dispatch of eight mice and of nine jobs over the
   digit classes against each job's own ``search`` (K1/K6). Then K3 and
   K4 the same way in every shape (the single arg-min launch, the until
   launch with the three targets at two grid sizes, both chains, the
   batch and the searcher's batches), K4 also from a hoist built with the
   deep window. K6's mesh bodies: the two mesh folds on 48 seeded cases
   (1 to 4 rows, ties, all-ones rows, found and not-found carries, bases
   whose low word wraps) against their plain versions, and the shard
   searches over four-way ``device_windows`` of four of the windows,
   merged by the fold kernels, against the plain scan and fold of the
   whole window; the until shards sharing one lowest-hit word, row by
   row against the plain until scan given the lowest hit so far, with
   the first hit in shard 0, in shard 2 only, nowhere, and after a hit
   (no lane work), each shard's handed-out runs read from its counter
   word (none above a stored hit), the folded carry also against the
   plain until scan of the whole window. K7 over one full wave against
   its plain version;
4. e2e: the port's scheduler server and a miner on ``cuda`` as
   subprocesses through their CLIs, requests submitted with the port's
   client. The arg-min path: R1 ("cmu440", 2^26-1), R2 (a 60-character
   message, 10^8-1) and a mouse ("cmu440", 10^5-1) against the plain scan
   on the card, R3 ("cmu440", 2^32-1) against the hashlib claim check and
   a direct ``NonceSearcher`` run at another grid size, and R1 again on a
   warm card. Then the difficulty path, on a new server and two miners
   (so that a request splits into two chunks): R4 ("cmu440", 2^32-1,
   target 2^64 // 10^8) through ``submit_until``, held to the claim
   check, to the target, and to the plain until scan on the card from 0,
   with a "(prefix release)" line in the server log when its hit lies in
   chunk 0; direct ``search_until`` runs over R4's range and over the
   second chunk [2^31, 2^32], at the default grid and at 37
   blocks, each equal to the plain until scan on the same range (the
   second chunk's answer is dropped by the prefix release, so this is
   where the until chain's hit-and-fold on real lanes is held to the
   plain version); and R5 ("cmu440", 2^26-1, target 1) through the
   client CLI's fifth argument, which must equal R1. Then the mice path,
   four times, on a new server (QoS chunking from 0.1 s, 0.05 s chunks)
   and two miners each time, in turns with the server's adapt plane on
   (the default) and then off (``DBMT_ADAPT=0``), each with coalescing
   on, then off, then twice on a warm pool, the admission
   controller (``DBMT_ADAPT_ADMIT=1``) on and then off (a
   second elephant, ("warm pool", 2^36-1), served first until the chunk
   controller has moved): a warm-up request that gives the scheduler its
   throughput sample, then an elephant ("cmu440", 2^34-1) and, while it
   runs, 64 mice of 10^5-10^6 nonces over 8 messages from 8 client
   connections; first with coalescing on (the mice share coalescing
   windows and batched K5 launches; the path fails if K5 never
   launched), then with ``DBMT_COALESCE=0`` (one launch chain per chunk),
   each mouse held to the plain scan on the card and the elephant to the
   claim check and a direct search at 1,001 blocks; the mice's p50/p99
   request seconds, the elephant's wall time and the coalesced
   dispatches and their mean width, the runs side by side, and the adapt
   plane's last values (``scheduler adapt``: chunk seconds, window bound,
   admission rate), each within its controller's floor and ceiling; a
   tenant shed only where the admission controller is on; every chunked
   activation planned from the chunk seconds in force (the plane's last
   logged value) at its logged pool rate, the planned chunks of every
   answered elephant served by the miners as planned, and on the warm
   pool an elephant planned from a moved value; the
   checks that count launches read the adapt-off runs. Then the
   peeled paths, each on a new server: two miners with ``DBMT_PEEL=1``
   (K4) serve R1, R2, R3 and R4 (R4 with the prefix release check); the
   mice path once more, with coalescing, on ``DBMT_PEEL=1`` miners; one
   miner with ``DBMT_PEEL=1 DBMT_HOIST=0`` (K3) serves R1, R2 and R4;
   every answer equal to the default path's, their launches K4 (then K3)
   and K6 (and K5's reduce) with no K1 or K2. Then the mesh paths, each
   on a new server, with ``DBMT_MESH_DEVICES`` naming every card, or card
   0 four times on a box with one: two mesh miners serve R1, R2, R3, the
   mouse and R4 (with the prefix release check), one peeled mesh miner
   (``DBMT_PEEL=1``) R1 and R4; every answer equal to the default
   path's, their launches the shard searches and reduces (K1 and K2, or
   K4 with K1/K2 reduces) and one mesh fold (K6mesh) per block served
   and distinct device, with no single-device K6 fold. Then the pod
   path, on a new server: one pod miner of two ranks on card 0
   (``parallel.multihost``; each rank a mesh of two shards of card 0,
   its rows over gloo, as NCCL refuses two ranks on one card) serves R1,
   R2, R3, the mouse and R4, every answer equal to the default path's,
   the server seeing one JOIN, each rank making one mesh fold and one
   row gather a block and no K6; then the follower-death drill: the
   follower of a new pod (``DBMT_POD_TIMEOUT_S=20``) is killed as its
   elephant job starts, the owner must exit 17 within the bound, and a
   plain miner that joins afterwards serves the chunk, equal to the mice
   path's elephant; then the replica path: a server of two scheduler
   replicas (``DBMT_REPLICAS=2``) and two miners serve R1, R3, R4 and
   the 64 mice, each equal to the default or mice path's, answered from
   both replicas' job-id ranges, the merged ``results_sent`` the server
   logs at its stop equal to the answers; then the procs path (the
   process tier, ``apps.procs``): a ``ProcCluster`` of a router, two
   replica processes, a miner agent and then a gateway agent with two
   children (so one joins each replica), every miner on card 0, a 0.2 s
   beat; R1, R3 and R4 through ``submit_with_retry("ring:<statedir>")``
   with a tenant key owned by each replica, equal to the default path's;
   ``tools/dbmtop.py --once --json``: five processes, all fresh; the
   elephant ("cmu440", 2^36-1) through the ring, its owner killed with
   ``kill -9`` once it has put it in flight: the router's missed-beat
   detection bumps the epoch and fences it, the one reply equals a
   direct search on card 0, the survivor answered it once, the seconds
   from the kill to the fence and to the reply printed; ``dbmtop``
   again: the dead replica fenced or stale and out of the totals, the
   three SLO objectives; each agent's launches (K1, K6, K2) from the
   gauges of its rollup blob, none in a replica or the router; and one
   host-tier miner agent (``DBMT_COMPUTE=host``) on a ring of its own
   serving R1, equal to the card's, with no launch. Then the gateway
   path: a server as the parent, ``apps.gateway`` (which joins it once
   its two children have) and two miners on ``cuda`` with probed rate
   hints behind its inner port; a warm 2^34 request, then R1, R3 and R4
   through the parent, equal to the default path's; the parent saw one
   JOIN, its hint the children's probes less their decay, at least one
   repeat JOIN logged as a refresh of that miner, and no failed claim;
   and a synchronised row gather of the pod timed (``--pod-gather``,
   one process a rank). The
   adapt-on mice run (coalescing on) runs with the capture plane armed
   (``DBMT_CAPTURE=1``): its answers equal the adapt-off run's, its
   records add up to the run's arrivals, answers, sheds and chunk
   Results, and its baseline's p50/p99 are printed beside the clients';
   its replay plan holds the traffic's tenants and sizes. Then the lease
   path, on a new server with 2 s leases (``DBMT_LEASE_GRACE_S``,
   ``DBMT_LEASE_FLOOR_S``), a 0.1 s sweep and 1 s age alarms: a wedged
   miner (this script's ``--fault-miner wedge``: the port's
   ``MinerWorker`` with each searcher wrapped in ``WedgeableSearcher``,
   its gate released by SIGUSR1) joins first, then one miner; R4, R3
   twice and R1, each answer equal to the default path's, the wedged
   miner's chunk 0 of the first three blowing its lease and re-issued
   (the third blow quarantines it), R1 served by the other miner as one
   chunk; then SIGUSR1: the wedged miner serves its three blown chunks
   late on the card (K2, K1, K6), which lifts its quarantine, and R1
   again splits over both; the server must log the blown leases, the
   re-issues, the quarantine, its lifting and the in-flight alarm. Then
   the verification path, on a new server auditing every arg-min chunk
   over its whole range (``DBMT_AUDIT_P=1``, ``DBMT_AUDIT_MAX=2^32``):
   two miners and two liars (``--fault-miner sentinel`` and
   ``wrong_hash``: ``ByzantineSearcher`` with its lie flag set) serve R3,
   R1 and R3, each equal to the default path's; the server must log a
   failed audit and a failed claim, and in the last request neither liar
   serves a chunk (both below the trust bar). Then the sched path, twice,
   adapt on and then off, on two new servers of two miners each, the
   result cache on. The first
   stripes in 0.05 s chunks (``SCHED_SERVER_ENV``) and one of its miners
   joins with a measured rate hint (``DBMT_RATE_HINT=probe``, the probe
   run on its card; the probe is launch-bound on an H100, so its hint
   is far below the steady rate, and at the default 5 s wholesale bound
   the cold pool would chunk R3 instead of striping it: this server's
   bound is 60 s): R3 on the cold pool, striped from the hint
   (``chunks_striped`` > 0), equal to the default path's; R3 again,
   answered from the cache with no launch on either miner; a message of
   2^33 nonces on the warm pool, striped, held to the claim check and a
   direct search; R4, equal to the default path's, with its prefix
   release over the ascending striped chunks. The second
   (``SCHED_QOS_ENV``: chunking, one admission token a tenant, one
   request queued at most, weights 1 and 3 by conn id) after a warm-up:
   the elephant and, while it runs, a tenant whose second mouse is shed
   at admission and four tenants writing a mouse each at once, past the
   queue's bound (the oldest shed); then two tenants' chunked elephants,
   the weight-3 one (written second) finishing first; every shed
   tenant's client disconnected and no other, the shed warnings adding
   up to ``qos_shed``, every answer equal to the plain scan, a direct
   search or the mice path's elephant; the adapt-on run is held to every
   answer (the warm message's and the weights' to the adapt-off run's)
   and its controllers to their bounds, the adapt-off run also to the
   striped chunk counts and the weights' order. The probe's hint is
   printed beside R3's nonces/s. Then the ``trace`` check, from the
   traces each server writes when it stops (``DBMT_TRACE_EXPORT``; every
   server runs in a directory of its own, ``e2e_<name>/``, where it logs
   to ``log.txt``): on the arg-min path every Result folded a span into
   its request's trace, each span's phases present and >= 0, its
   ``force_s`` no more than the request's seconds, and the Perfetto
   export one ``request`` slice a request; on the mice path each
   coalesced window's spans share one launch id, as many as its lanes;
   on the lease path a flight-recorder dump is one JSON line holding the
   blown leases; R4's and R5's seconds split into their chunks' span
   phases and the scheduler's remainder. Then the ``metrics`` check (its
   own JSON line), from the snapshots each process's metrics emitter
   logs: every 30 s, at its exit (a miner on SIGTERM too), and every
   0.1 s on the mice, lease and verification servers
   (``METRICS_ENV``). On the arg-min path the miner's
   ``miner.nonces_scanned`` equals the nonces of the chunks the
   scheduler assigned (its exported traces), its
   ``miner.chunks_served`` its ``counts()["chunks"]``, its
   ``model.device_launches`` since its launch counts restarted the
   search launches counted (K1-K4, K5's less a reduce a batched
   launch), no ``sched.miner_trust`` below 1.0, and
   ``sched.pool_rate_nps`` beside ``miner.nonces_per_s`` (within
   ``RATE_FACTOR`` either way where the scheduler has a rate); on the
   mice path (coalescing on, adapt off) each miner the same and its
   coalesced dispatches and chunks equal to its counts,
   ``sched.stripe_chunks_per_share`` a sample per miner share of each
   wholesale dispatch, every tenant's ``sched.qos_granted_chunks`` in
   every line at most the chunks its traces show granted (the series
   retires with its tenant, so the share of the grants seen is
   printed) and the rates within ``RATE_FACTOR``; on the lease path
   ``sched.pool_quarantined`` at least 1 during the quarantine and 0
   in the last line; on the verification path each convicted miner's
   ``sched.miner_trust`` below 1; on the procs path ``dbmtop``'s row of
   the live replica after the kill a number in ``lease_min_s`` and
   ``nps`` and no ``trust_min`` below 1.0. Every other server runs with
   ``DBMT_AUDIT_P=0`` (random audits would add launches no path
   expects), ``DBMT_CACHE=0`` (the cache would answer the repeated R1,
   R3 of the arg-min, lease and verification paths without the miners)
   and leases at their defaults; each server's count of blown leases is
   reported. Every other miner is pinned to card 0. The launch counts
   of each path come from its own miner processes, which start at 0
   just before the path;
   Then the harness paths (``phase_harness``), each its own JSON line
   with its seconds: the chaos path, in a worker process of its own
   (``--chaos-storm SEED``, so that the global fault knobs never touch
   this process): the port's scheduler on a localhost LSP server (2 s
   leases, a 0.1 s sweep, quarantine after 3 blown leases, every
   arg-min chunk audited over at most 2^20 nonces, no result cache) and
   three ``ChaosMiner`` handles on card 0 (``beta`` lying in
   ``wrong_hash`` mode during the turn-coat episodes), the seeded
   schedule (``seed_packet_faults(11)``, ``generate_schedule(11, 8.0,
   ...)`` over ``BYZ_EPISODES``, printed, equal to a second generation)
   applied while a client submits R1, R3, R4 and ("chaos storm", 2^32-1)
   through ``submit_with_retry`` round after round; every answer equal
   to the default path's or to a direct search on card 0 and the claim
   check, one Result reaching the client a request, the pool converged
   afterwards, and K1, K2 and K6 launched by the storm's miners (their
   launches join the ``kernels`` line's); the process storm: a
   ``ProcCluster`` (router, 2 replicas, 2 miner agents on card 0, a 0.2 s
   beat) through one ``ProcEpisode`` of each kind (a replica's SIGKILL,
   its SIGSTOP, the router's SIGKILL; each request 2^33-2^34 nonces),
   each reply once and equal to a direct search on card 0, the seconds
   from the fault to the fence and to the reply, and the agents'
   launches from their rollup gauges; the replay: the adapt-on mice
   run's capture re-sent through ``run_replay`` (detnet) and
   ``run_replay_procs``, each sending the plan's requests, completed
   plus shed equal to them, with the fidelity verdict printed; the load
   harness on the card's host (1,000 tenants on 1 and 4 replicas,
   ``mice_stampede`` static and adaptive, 200 tenants over the process
   tier): every request not shed completes; and the transport bench (2
   rounds of 2 s legs, fast and stock, and resident bytes a conn at
   10,000 conns, in child processes);
   Then the analysis phase (``phase_analysis``, its own JSON line), its
   three parts started together: ``tools/dbmlint.py --list`` on this
   tree (exit 0, no finding); ``tools/dbmcheck.py --seeds 10 --dfs 8``
   over the explorer's 17 scenarios (exit 0, no violation); and, in a
   worker (``--analysis-card``), ``pipelined_dispatch`` and
   ``batched_dispatch`` for 8 seeds each with the fake searcher swapped
   for ``CardSearcher`` (``card_scenarios``: ``NonceSearcher`` on card
   0 behind the fake's virtual-clock charges, so each schedule must be
   the fake's step for step), every Result held to the oracle by the
   scenarios' checks, K1, K5 and K6 each launched (their launches join
   the ``kernels`` line's);
5. rates: K1 over one full 10^9 block (1-block tail), R2's 9*10^8 block
   (2-block tail with digits in both blocks) and a 10^9 block whose second
   tail block holds no digit; K2 over the first block with a target
   nothing meets, and on a 10^9 block whose first hit lies a little past
   lane 10^8 (to the hit, and with no target, beside K1 on that block);
   the plain scans over 2^22 lanes; K6's arg-min chain over R3's blocks
   and over the mouse's range against per-block K1 launches with one
   stacked fetch; K6's until
   chain to the first hit of that 10^9 block and over R4's range, and a
   chained until launch after a hit; and the two difficulty shapes on
   R4's two chunks served back to back by one searcher: the chain
   against one K2 launch per block read in ascending order, with and
   without one launch of lookahead. K5: the eight mice of 10^6 nonces (56
   rows) as one batched dispatch and fetch against the same jobs through
   eight K1/K6 chains, K5 alone on those rows with proportional and with
   even grid shares, the plain version on them, and K5 over eight rows of
   10^8 lanes beside K1's time per 10^9. K3 and K4 beside K1 on the
   three K1 blocks, on R3's chain, to K2's first hit and on the mice
   rows (each K5 call also cut into its launches alone and the host's
   plan table). From fixed-shape builds of all three bodies, each
   kernel's SASS instructions a nonce (its lane loop and a tenth of the
   run loop around it), and for K1 and K4 by pipe, INT32, FMA and other,
   with the measured rate's share of K7's INT32 ceiling and of the issue
   bound (``pipes``). K6's reduce-and-fold kernels alone on a wave's
   partials (device time over 200 launches, beside their bytes bound).
   The mesh: R3's chain on meshes of 1, 2 and 4 shards of card 0
   against the K6 chain, in turns, the until chain on 4 shards against
   the K6 chain to K2's first hit and over its block with no hit, each
   mesh fold on the card alone (200 launches) against its plain
   version, the mesh's ``hit_scope`` on a line of its own, and on a box
   with more than one card the same chains over a mesh of every card,
   also in ``"card"`` scope (hits shared on each card only; on one card
   the output says it was not run); and
   ``tools.tune`` once as a subprocess, given this run's INT32
   instructions a nonce of K1 and K4 (K7's ceiling and the nonce/s it
   allows them, K1's grid sweep, K1 beside its plain scan, K2's miss and
   first-lane hit); K7's bound is the work its function needs
   (``K7_CLOCKS_PER_LANE_ITER``), not its emitted SASS. Timed with
   CUDA events, beside the bound from the integer work each nonce needs
   (``needed_int_ops``: a run of lanes' shared work over its lanes, and
   each lane's own; plus the target compare for K2), the larger of two
   floors (``bound_floors``): every instruction at the SM's issue rate,
   and the busier of the INT32 and FMA pipes with the rotates placed on
   them at best (a rotate is one SHF on the INT32 pipe or two IMADs on
   the FMA pipe); beside it, not as a floor, every rotate and logic
   instruction on the INT32 pipe (``int32_only_ms``) and the INT32
   instructions of K1's own SASS loop on that pipe.

6. census: ``tools.trace_census`` as a subprocess, given the rates
   phase's census of K1's lane body on the 1-block tail (its SASS
   instructions a nonce by pipe and the work a nonce needs): one K1
   search of 2^29 lanes and R3's chain under ``torch.profiler``, each
   call's kernel device time, busy union, window and idle share, and
   nonces/s from device time, printed beside the card's name and power
   limit.

Then the ``kernels`` line and, last, the ``ok`` line. Any failure exits
non-zero without the ``ok`` line. It imports nothing of JAX.
"""

from __future__ import annotations

import ast
import glob
import hashlib
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "distributed_bitcoinminer_tpu_torch"
#: Instructions one Hopper SM issues a clock: four schedulers, one warp
#: instruction (32 lanes) each. No integer work issues faster. The INT32
#: pipe takes 64 lanes a clock, but the compiler also puts integer adds,
#: shifts and moves on the FMA pipe (IMAD, VIADD), and a rotate can go
#: there as two IMADs, so the INT32 pipe bounds a lane only through the
#: logic and what rotates it keeps (``bound_floors``).
RATE_ISSUE_PER_CLK_PER_SM = 128
RATE_INT32_PER_CLK_PER_SM = 64     # INT32 lanes of one Hopper SM per clock
RATE_FMA_PER_CLK_PER_SM = 64       # IMAD lanes of its FMA pipe per clock


#: Where every phase line is also written in full (the standard output a
#: caller keeps may be cut to its end).
PHASES_LOG: list = []


def emit(phase: str, **fields) -> None:
    line = json.dumps({"phase": phase, **fields})
    print(line, flush=True)
    for path in PHASES_LOG:
        with open(path, "a") as f:
            f.write(line + "\n")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi(query: str) -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        fail("nvidia-smi not found")
    out = subprocess.run([exe, f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi --query-gpu={query}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


# --------------------------------------------------------------- helpers

def tail_case(rem: int, k: int):
    """(prefix, midstate, template) whose tail holds ``rem`` bytes before
    the k digits: the prefix is one full block of filler plus rem bytes."""
    from distributed_bitcoinminer_tpu_torch.ops.sha256_host import \
        sha256_midstate
    from distributed_bitcoinminer_tpu_torch.ops.sha256_torch import \
        build_tail_template
    prefix = bytes((97 + (j % 26)) for j in range(64 + rem))
    midstate, tail = sha256_midstate(prefix)
    assert len(tail) == rem
    return prefix, midstate, build_tail_template(tail, k, len(prefix) + k)


M32 = 0xFFFFFFFF


def words(t) -> tuple:
    """A device vector's words as uint32 ints."""
    return tuple(int(x) & M32 for x in t.to("cpu").tolist())


def event_ms(fn) -> float:
    """Milliseconds of one ``fn()`` between CUDA events (``fn`` may end in
    a host fetch; the stop event is recorded after it returns)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def lane_hashes(mid, tmpl, i0: int, n: int, rem: int, k: int, dev):
    """The 64-bit hash of every lane ``i0 + [0, n)``, as numpy uint64,
    from the plain lane tier on the card."""
    import numpy as np
    import torch
    from distributed_bitcoinminer_tpu_torch.ops.sha256_torch import \
        hash_lanes
    i = torch.arange(i0, i0 + n, dtype=torch.int64, device=dev)
    hi, lo = hash_lanes(mid, tmpl, i, rem, k)
    return ((hi.cpu().numpy().astype(np.uint64) << np.uint64(32))
            | lo.cpu().numpy().astype(np.uint64))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs after one warm-up,
    between CUDA events."""
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


def device_ms(fn, reps: int = 200) -> float:
    """Mean device milliseconds of ``fn`` (a few tiny launches) over
    ``reps`` back-to-back runs, between CUDA events: the stream is held
    by a spin kernel while the launches are queued behind it, so the
    events time the card running them, not the host queuing them (a run
    whose queuing outlasts the spin fails)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)     # ~0.1 s at the H100's 1.98 GHz
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    if start.query():
        fail("device_ms: the launches were queued after the spin ended")
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def sass_loop_instructions(lib: str, variant: int, outdir: str,
                           tag: str = "",
                           kernel: str = "sha256_argmin_kernelILi{v}E"):
    """Instructions a nonce of a search kernel's lane work (the arg-min
    kernel's, or ``kernel``'s, its mangled name's start with the variant
    as ``{v}``) for the variant's instantiation (0: 1-block
    tail, 1: the last digit in block 1, 2: a digit-free second block), from
    ``cuobjdump -sass`` (``tools.tune.sass_loops``). The widest loop walks
    the runs (K2: its grabs) and the widest loop inside it with no loop
    inside it is the lane loop, so a nonce costs the lane loop and a
    ``RUN_LANES``-th of the rest of the run loop (a kernel with one loop,
    the parent design's, costs that loop). Returns (instructions a nonce,
    the kernel's instructions, opcode counts a nonce, the loops'
    instructions ``{"run_loop": .., "lane_loop": ..}``)."""
    from distributed_bitcoinminer_tpu_torch.ops.sha256_cuda import RUN_LANES
    from distributed_bitcoinminer_tpu_torch.tools.tune import (opcode_counts,
                                                               sass_loops)
    body, loops, total = sass_loops(lib, kernel.format(v=variant))
    with open(os.path.join(outdir, f"sass{tag}_v{variant}.txt"), "w") as f:
        f.write(body)

    def inside(a, b):   # loop a strictly inside loop b
        return b[0] <= a[0] and a[1] <= b[1] and (a[0], a[1]) != (b[0], b[1])
    lo, hi, outer = max(loops, key=lambda lp: lp[1] - lp[0])
    inner = [lp for lp in loops if inside(lp, (lo, hi))]
    inner = [lp for lp in inner if not any(inside(o, lp) for o in inner)]
    ops = opcode_counts(outer)
    sizes = {"run_loop": len(outer)}
    if inner:
        lane_loop = max(inner, key=lambda lp: lp[1] - lp[0])[2]
        lane = opcode_counts(lane_loop)
        ops = {op: lane.get(op, 0) + (n - lane.get(op, 0)) / RUN_LANES
               for op, n in ops.items()}
        sizes["lane_loop"] = len(lane_loop)
    return sum(ops.values()), total, ops, sizes


# ---------------------------------------------------------------- phases

class ClockSampler:
    """``nvidia-smi``'s SM clock and power draw every 50 ms while the
    ``with`` block runs."""

    def __enter__(self):
        self._proc = subprocess.Popen(
            [shutil.which("nvidia-smi") or "nvidia-smi",
             "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader",
             "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True)
        return self

    def __exit__(self, *exc):
        self._proc.terminate()
        out, _ = self._proc.communicate(timeout=20)
        lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
        self.samples = lines[len(lines) // 4:]   # drop the ramp-up
        return False


def phase_device() -> dict:
    import torch
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    info = {"name": name, "torch": torch.__version__,
            "cuda": torch.version.cuda, "count": torch.cuda.device_count(),
            "nvidia_smi": smi,
            "sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "clocks_max_sm_mhz": nvidia_smi("clocks.max.sm")}
    emit("device", **info)
    return info




#: The peeled bodies: (kernel, lane body of ops.sha256_cuda, its
#: plain version reads the hoist).
PEELED = (("K3", "peel", False), ("K4", "hoist", True))
#: The bodies whose SASS the rates phase reads from fixed-shape builds.
SASS_BODIES = (("K1", "rolled"), ("K3", "peel"), ("K4", "hoist"))


def fixed_shape(body: str, rem: int, k: int) -> tuple:
    """The (shape, shape1, lw) a plan takes in the lane bodies
    (``LaneBody`` in the source): 4 t* (+ block 0's digit words under
    K4), the second block's spill shape, and the last digit's tail
    word."""
    a, last = rem >> 2, (rem + k - 1) >> 2
    shape = 4 * a + ((min(last, 15) - a + 1) if body == "hoist" else 0)
    return shape, 2 * (a - 14) + last - 16, last


def sass_probe_commands() -> dict:
    """nvcc commands of the SASS-reading builds: each body with the shapes
    of the three rates blocks fixed at compile time
    (``DBMT_FIXED_SHAPE``, ``DBMT_FIXED_SHAPE1``, ``DBMT_FIXED_LW``), so
    that the arg-min kernel's loops are the path those lanes run.
    ``{(body, case): (library, command)}``."""
    from distributed_bitcoinminer_tpu_torch.ops import sha256_cuda
    cmds = {}
    for _, body in SASS_BODIES:
        for case, (rem, k) in RATE_SHAPES.items():
            shape, shape1, lw = fixed_shape(body, rem, k)
            lib = os.path.join(sha256_cuda.BUILD_DIR,
                               f"sass_probe_{body}_{case}.so")
            cmd = sha256_cuda._nvcc_command(body, lib)
            cmds[body, case] = (lib, cmd[:-3] + [
                f"-DDBMT_FIXED_SHAPE={shape}",
                f"-DDBMT_FIXED_SHAPE1={shape1}",
                f"-DDBMT_FIXED_LW={lw}"] + cmd[-3:])
    return cmds


def ptxas_kernels(text: str) -> dict:
    """Registers and spill stores of each kernel in nvcc's ptxas report."""
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:   # the kernel and its template arguments, demangled
            m = re.search(r"\d+((?:sha256|segmin|reduce|mesh|alu)"
                          r"\w*?_kernel)"
                          r"(I(?:L[^E]*E)+E)?", m.group(1))
            name = m.group(1) + (m.group(2) or "")
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kernels.setdefault(name, {})["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            kernels.setdefault(name, {})["spill_stores"] = int(m.group(1))
    return kernels


def phase_build(outdir: str) -> dict:
    """The three lane bodies' libraries, one nvcc each, all at once, and
    beside them the SASS-reading builds of the peeled bodies. Reports
    each kernel's registers and spills (ptxas) and its resident blocks
    per SM."""
    import threading

    from distributed_bitcoinminer_tpu_torch.ops import alu_probe, sha256_cuda
    t0 = time.monotonic()
    os.makedirs(sha256_cuda.BUILD_DIR, exist_ok=True)
    probes = {key: (lib, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                          stderr=subprocess.PIPE, text=True))
              for key, (lib, cmd) in sass_probe_commands().items()}
    k7 = threading.Thread(target=alu_probe.build)   # K7's nvcc beside
    k7.start()
    sha256_cuda.build_all()
    k7.join()
    alu_probe.build()   # up to date by now, or raises nvcc's error
    info = {"seconds": round(time.monotonic() - t0, 3), "bodies": {}}
    for body in sha256_cuda.BODIES:
        lib = sha256_cuda.load(body)
        b_info = sha256_cuda.build_info[body]
        ptxas = b_info.get("ptxas", "")
        with open(os.path.join(outdir, f"ptxas_{body}.txt"), "w") as f:
            f.write(ptxas)
        kernels = ptxas_kernels(ptxas)
        blocks = {entry: [lib.dbmt_sha256_blocks_per_sm(e, v)
                          for v in range(3)]
                  for e, entry in enumerate(("argmin", "until", "segmin"))}
        info["bodies"][body] = {
            "nvcc_seconds": round(b_info.get("seconds", 0), 3),
            "built": b_info.get("built"),
            "threads": lib.dbmt_sha256_argmin_threads(),
            "plan_words": lib.dbmt_sha256_plan_words(),
            "blocks_per_sm": blocks, "kernels": kernels,
            "instantiations": instantiations(kernels, blocks)}
    for (body, case), (lib, proc) in probes.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            fail(f"the SASS-reading build {body} {case} failed: "
                 f"{err[-3000:]}")
    info["sass_probe_seconds"] = round(time.monotonic() - t0, 3)
    info["K7"] = {"nvcc_seconds": round(alu_probe.build_info.get(
                      "seconds", 0), 3),
                  "built": alu_probe.build_info.get("built"),
                  "ptxas": alu_probe.build_info.get("ptxas", "")[-400:],
                  "threads": alu_probe.threads(),
                  "blocks_per_sm": alu_probe.load()
                  .dbmt_alu_probe_blocks_per_sm()}
    emit("build", **info)
    return info


#: The search kernels by entry: (kernel, the mangled template arguments of
#: variant v, the entry's name in dbmt_sha256_blocks_per_sm's order).
SEARCH_KERNELS = {"K1": ("sha256_argmin_kernel", "ILi{v}EE", "argmin"),
                  "K2": ("sha256_until_kernel", "ILi{v}ELb0EE", "until"),
                  "K5": ("sha256_segmin_kernel", "ILi{v}EE", "segmin")}


def instantiations(kernels: dict, blocks: dict) -> dict:
    """Each search kernel's instantiation by variant (0: 1-block tail, 1:
    the last digit in block 1, 2: a digit-free second block): its
    registers and spill stores (:func:`ptxas_kernels`) and its resident
    blocks per SM."""
    out = {}
    for kern, (name, args, entry) in SEARCH_KERNELS.items():
        for v in range(3):
            k = kernels.get(name + args.format(v=v), {})
            out[f"{kern}<{v}>"] = [k.get("registers"), k.get("spill_stores"),
                                   blocks[entry][v]]
    return out


#: Windows that cut runs of lanes (``RUN_LANES``) or lie inside one, as
#: (rem, k, i0, n, lo_i, hi_i): three runs cut at both ends; shorter than
#: a run, inside one (a spilling 2-block tail); the top five lanes of a
#: 10^9 block (a digit-free second block); seven lanes across a run
#: boundary; one lane; the last lane of k = 1.
CUT_RUN_WINDOWS = ((8, 9, 123_456_781, 40, 123_456_783, 123_456_806),
                   (61, 9, 100_000_003, 7, 100_000_004, 100_000_008),
                   (52, 9, 999_999_995, 5, 999_999_995, 999_999_999),
                   (31, 5, 17, 7, 17, 23),
                   (63, 2, 45, 1, 45, 45),
                   (0, 1, 0, 10, 9, 9))


#: One window of each 2-block tail shape at 2^18 lanes, as (rem, k, i0, n,
#: lo_i, hi_i), valid edges off the run edges: the last digit in the
#: second block (rem 61, R2's shape), and a digit-free second block (rem
#: 52, the 50-character message's).
SHAPE_WINDOWS = ((61, 9, 100_000_007, (1 << 18) + 9, 100_000_011,
                  100_262_150),
                 (52, 9, 999_700_003, 1 << 18, 999_700_005, 999_962_140))


def kernel_windows():
    """The 30 rem x k cases, (rem, k, prefix, mid, tmpl, i0, n, lo_i,
    hi_i), valid edges off the thread, block and run edges; then the
    :data:`CUT_RUN_WINDOWS` and the :data:`SHAPE_WINDOWS`."""
    for rem in (0, 1, 3, 4, 31, 32, 55, 56, 62, 63):
        for k in (1, 5, 9):
            prefix, mid, tmpl = tail_case(rem, k)
            if k == 9:
                i0, n = 123_456_789, (1 << 20) + 4_099
                lo_i, hi_i = i0 + 1_013, i0 + n - 777
            else:
                i0, n = 0, 10 ** k
                lo_i, hi_i = i0 + min(3, n - 1), i0 + n - 1 - min(5, n - 1)
            yield rem, k, prefix, mid, tmpl, i0, n, lo_i, hi_i
    for rem, k, i0, n, lo_i, hi_i in CUT_RUN_WINDOWS + SHAPE_WINDOWS:
        yield (rem, k, *tail_case(rem, k), i0, n, lo_i, hi_i)


def variants_of(cases) -> dict:
    """How many of ``cases`` (each led by rem, k and a template) fall in
    each variant (0: 1-block tail, 1: the last digit in block 1, 2: a
    digit-free second block); fails unless every variant has one."""
    from distributed_bitcoinminer_tpu_torch.ops.sha256_cuda import \
        variant_of
    counts = {0: 0, 1: 0, 2: 0}
    for rem, k, tmpl in cases:
        counts[variant_of(rem, k, int(tmpl.shape[0]))] += 1
    if not all(counts.values()):
        fail(f"the checked windows miss a tail shape: {counts}")
    return counts


def body_kw(body, mid, tmpl, rem: int, k: int, deep: bool = False) -> dict:
    """The search wrappers' lane-body arguments: none for the rolled body,
    ``peel`` for K3, ``peel`` and the host hoist for K4 (``deep``: built
    with the 48-round window)."""
    from distributed_bitcoinminer_tpu_torch.ops.sha256_torch import \
        build_hoist
    if body is None:
        return {}
    if body == "K3":
        return {"peel": True}
    return {"peel": True,
            "hoist": build_hoist(mid, tmpl, rem, k, deep_window=deep).ops}


def check_k1(dev, body=None) -> dict:
    """K1 (K3, K4 with ``body``) against its plain scan and hashlib on
    every window; K4 also from a hoist built with the deep window."""
    from distributed_bitcoinminer_tpu_torch.ops import search, sha256_cuda
    cases, max_err, n_total = [], 0, 0
    for rem, k, prefix, mid, tmpl, i0, n, lo_i, hi_i in kernel_windows():
        kw = body_kw(body, mid, tmpl, rem, k)
        got = words(sha256_cuda.sha256_argmin(
            mid, tmpl, i0, lo_i, hi_i, n, rem=rem, k=k, device=dev, **kw))
        want = words(search.span_scan(mid, tmpl, i0, lo_i, hi_i, n,
                                      rem=rem, k=k, device=dev,
                                      hoist=kw.get("hoist")))
        err = max(abs(a - b) for a, b in zip(got, want))
        if body == "K4":
            deep = body_kw(body, mid, tmpl, rem, k, deep=True)
            got_deep = words(sha256_cuda.sha256_argmin(
                mid, tmpl, i0, lo_i, hi_i, n, rem=rem, k=k, device=dev,
                **deep))
            err = max(err, *(abs(a - b) for a, b in zip(got_deep, want)))
        max_err = max(max_err, err)
        digest = hashlib.sha256(prefix + f"{got[2]:0{k}d}".encode()).digest()
        hashed = (int.from_bytes(digest[:4], "big"),
                  int.from_bytes(digest[4:8], "big"))
        ok = err == 0 and hashed == got[:2] and lo_i <= got[2] <= hi_i
        cases.append({"rem": rem, "k": k, "nblocks": int(tmpl.shape[0]),
                      "lanes": n, "ok": ok})
        n_total += n
        if not ok:
            emit("kernel", failed=cases[-1], kernel=body or "K1", got=got,
                 want=want, hashlib=hashed)
            fail(f"{body or 'K1'} disagrees at rem={rem} k={k}")
    return {"cases": len(cases), "lanes": n_total, "max_abs_err": max_err,
            "two_block_cases": sum(c["nblocks"] == 2 for c in cases)}


_TARGETS: dict = {}


def window_targets(rem, k, mid, tmpl, i0, n, lo_i, hi_i, dev) -> dict:
    """The window's three targets and the first qualifying lane of each
    (None: none), from its lanes' hashes on the card (computed once)."""
    import numpy as np
    key = (rem, k, i0, n, lo_i, hi_i)
    if key not in _TARGETS:
        valid = lane_hashes(mid, tmpl, i0, n, rem, k, dev)[
            lo_i - i0:hi_i - i0 + 1]
        targets = {"mid_window": int(valid.min()) + 1,
                   "dense": int(np.sort(valid)[len(valid) // 2]),
                   "miss": int(valid.min())}
        firsts = {}
        for name, t in targets.items():
            q = np.nonzero(valid < np.uint64(t))[0]
            firsts[name] = lo_i + int(q[0]) if len(q) else None
        _TARGETS[key] = (targets, firsts)
    return _TARGETS[key]


def check_k2(dev, body=None) -> dict:
    """K2 (its search under K3, K4 with ``body``) against the plain until
    scan on every window, with three targets; the dense one at the
    default grid and at 37 blocks. found and f_idx must equal the plain
    scan's and the first qualifying lane of the window's hashes; the
    arg-min words must equal when found is 0."""
    from distributed_bitcoinminer_tpu_torch.ops import search, sha256_cuda
    runs, max_err, shapes = 0, 0, []
    for rem, k, _, mid, tmpl, i0, n, lo_i, hi_i in kernel_windows():
        shapes.append((rem, k, tmpl))
        targets, firsts = window_targets(rem, k, mid, tmpl, i0, n, lo_i,
                                         hi_i, dev)
        kw = body_kw(body, mid, tmpl, rem, k)
        for name, t in targets.items():
            first = firsts[name]
            want = words(search.span_until_scan(
                mid, tmpl, i0, lo_i, hi_i, n, t >> 32, t & M32, rem=rem,
                k=k, device=dev, hoist=kw.get("hoist")))
            for grid in ((None, 37) if name == "dense" else (None,)):
                got = words(sha256_cuda.sha256_until(
                    mid, tmpl, i0, lo_i, hi_i, n, t >> 32, t & M32, rem=rem,
                    k=k, device=dev, grid=grid, **kw))
                cmp = 5 if not want[0] else 2
                err = max(abs(a - b) for a, b in zip(got[:cmp], want[:cmp]))
                max_err = max(max_err, err)
                runs += 1
                ok = (err == 0 and bool(want[0]) == (first is not None)
                      and (first is None or want[1] == first))
                if not ok:
                    emit("kernel", failed={"kernel": body or "K2",
                                           "rem": rem, "k": k,
                                           "target": name, "grid": grid},
                         got=got, want=want, first=first)
                    fail(f"{body or 'K2'} until disagrees at rem={rem} "
                         f"k={k} target={name} grid={grid}")
    return {"runs": runs, "max_abs_err": max_err,
            "windows_by_variant": variants_of(shapes)}


def chain_windows(dev):
    """Four 2^16-lane windows of "cmu440" in the 10^9 blocks from 10^10
    (nonces past 2^32, a different midstate each), placed so that the
    third window holds a hash below every hash of the first two; the
    target one above it hits there first."""
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
    s = NonceSearcher("cmu440", device=dev)
    off = 12_345
    while True:
        plans = [next(iter(s.plan(10 ** 10 + b * 10 ** 9 + off,
                                  10 ** 10 + b * 10 ** 9 + off + 65_535)))
                 for b in range(4)]
        mins = [int(lane_hashes(p.midstate, p.template, p.lo_i, p.lanes,
                                p.rem, p.k, dev).min()) for p in plans]
        if mins[2] < min(mins[0], mins[1]):
            return plans, mins[2] + 1
        off += 99_991


def check_k6(dev, body=None) -> dict:
    """K6's arg-min and until chains (their searches under K3, K4 with
    ``body``) against the plain scans and folds, carry words after every
    block; after the until chain's hit, its timing-dependent arg-min
    words are not compared, and the next launch must leave the kernel's
    carry as it was."""
    from distributed_bitcoinminer_tpu_torch.ops import search, searchop
    plans, t = chain_windows(dev)
    max_err, hit_block = 0, None
    for op in (searchop.ARGMIN_OP, searchop.UNTIL_OP):
        until = op is searchop.UNTIL_OP
        step = search.devloop_span_until if until else search.devloop_span
        carry_k, carry_p = search.devloop_carry(op, dev), op.init()
        prev_k = None
        for b, p in enumerate(plans):
            args = (p.lo_i, p.lo_i, p.hi_i, p.lanes)
            args += (t >> 32, t & M32, p.base) if until else (p.base,)
            kw = body_kw(body, p.midstate, p.template, p.rem, p.k)
            carry_k = step(p.midstate, p.template, carry_k, *args,
                           rem=p.rem, k=p.k, device=dev, **kw)
            carry_p = step(p.midstate, p.template, carry_p, *args,
                           rem=p.rem, k=p.k, device="cpu", **kw)
            got, want = words(carry_k), words(carry_p)
            cmp = 3 if until and want[0] else len(want)
            err = max(abs(a - b) for a, b in zip(got[:cmp], want[:cmp]))
            max_err = max(max_err, err)
            after_hit = until and prev_k is not None and prev_k[0]
            if until and want[0] and hit_block is None:
                hit_block = b
            if err or (after_hit and got != prev_k):
                emit("kernel", failed={"kernel": body or "K6",
                                       "op": op.name, "block": b},
                     got=got, want=want, before=prev_k)
                fail(f"{body or 'K6'} {op.name} chain disagrees at block "
                     f"{b}")
            prev_k = got
    if hit_block != 2:
        fail(f"K6 until chain hit in block {hit_block}, not 2")
    return {"blocks": len(plans), "lanes_per_block": plans[0].lanes,
            "until_hit_block": hit_block, "max_abs_err": max_err}


def segmin_batch():
    """K5's mixed batch: rows of four messages (1-block and 2-block
    tails, the 60-character one among them) over digit classes 1-9,
    ragged (3 to 2^18 + 5 lanes), valid edges off the block and run
    edges, one segment of three rows (a block cut in three), a segment of
    two rows shorter than a run of lanes, an empty-window row in a
    segment of its own and one in a segment with a valid row. Returns
    (rows, seg)."""
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
    msgs = ("cmu440", R2_DATA, DIGIT_FREE_DATA, "x" * 33)
    rows, seg = [], []

    def row(p, i0, lo_i, hi_i, n):
        return (p.midstate, p.template, i0, lo_i, hi_i, n, p.rem, p.k)
    for d in range(1, 10):
        s = NonceSearcher(msgs[d % 4], device="cpu")
        lo = 0 if d == 1 else 10 ** (d - 1)
        width = min(10 ** d - lo, (1 << 18) + 5)
        (p,) = list(s.plan(lo + 3 * (d > 1), lo + width - 1 - 2 * (d > 2)))
        if d % 2 and d > 1:   # lanes masked at both ends of the row
            rows.append(row(p, p.lo_i - 3, p.lo_i, p.hi_i, p.lanes + 5))
        else:
            rows.append(row(p, p.lo_i, p.lo_i, p.hi_i, p.lanes))
        seg.append(len(seg))
    # A block cut into three rows of one segment, the cuts off thread edges.
    (p,) = list(NonceSearcher("cmu440", device="cpu").plan(
        5 * 10 ** 8 + 1_000, 5 * 10 ** 8 + 301_000))
    cuts = (p.lo_i, p.lo_i + 100_003, p.lo_i + 200_107, p.hi_i + 1)
    for a, b in zip(cuts, cuts[1:]):
        rows.append(row(p, a, p.lo_i, p.hi_i, b - a))
        seg.append(seg[-1] + 1 if a == cuts[0] else seg[-1])
    # Rows shorter than one run of lanes: inside one run, and across a
    # run boundary, in one segment.
    rows.append(row(p, p.lo_i + 4, p.lo_i + 4, p.lo_i + 6, 3))
    seg.append(seg[-1] + 1)
    rows.append(row(p, p.lo_i + 17, p.lo_i + 17, p.lo_i + 22, 6))
    seg.append(seg[-1])
    # One row of each 2-block tail shape, each a segment of its own: the
    # last digit in block 1 (R2's message at 10^8) and a digit-free second
    # block (the 50-character message at 10^9).
    for data, lower in ((R2_DATA, 10 ** 8 + 7), (DIGIT_FREE_DATA,
                                                 10 ** 9 + 3)):
        (q,) = list(NonceSearcher(data, device="cpu").plan(lower,
                                                           lower + 70_000))
        rows.append(row(q, q.lo_i, q.lo_i, q.hi_i, q.lanes))
        seg.append(seg[-1] + 1)
    # Empty windows (lo_i > hi_i): alone, then beside a valid row.
    rows.append(row(p, p.lo_i, p.lo_i + 1, p.lo_i, 4_096))
    seg.append(seg[-1] + 1)
    rows.append(row(p, p.lo_i, p.lo_i + 1, p.lo_i, 4_096))
    seg.append(seg[-1] + 1)
    rows.append(rows[0])
    seg.append(seg[-1])
    return rows, seg


def mice_jobs(dev, n_lanes: int = 10 ** 6):
    """Eight argmin jobs ``[0, n_lanes]`` over eight messages (three of
    them with 2-block tails): ``[(searcher, 0, n_lanes), ...]``, the
    shape one coalesced launch of eight mice takes."""
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
    return [(NonceSearcher(m, device=dev), 0, n_lanes) for m in MICE_DATA]


def check_k5(dev, body=None) -> dict:
    """K5 (its searches under K3, K4 with ``body``) against its plain
    version on the mixed batch at the default grid and at 37 blocks, word
    for word; then the searcher's batched dispatch of the eight mice jobs
    and of nine jobs over digit classes 1-9 (default grid, and 37 blocks)
    against each job's own ``search`` (the K1/K6 chain, or K3's or
    K4's)."""
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
    from distributed_bitcoinminer_tpu_torch.ops import search, sha256_cuda
    rows, seg = segmin_batch()
    peel = {} if body is None else {"peel": True}
    if body == "K4":
        rows = [r + (body_kw(body, r[0], r[1], r[6], r[7])["hoist"],)
                for r in rows]
    want = [words(t) for t in search.span_segmin_scan(rows, seg,
                                                        device=dev)]
    max_err = 0
    for grid in (None, 37):
        got = [words(t) for t in sha256_cuda.sha256_segmin(
            rows, seg, device=dev, grid=grid, **peel)]
        err = max(abs(a - b) for g, w in zip(got, want)
                  for a, b in zip(g, w))
        max_err = max(max_err, err)
        if err:
            emit("kernel", failed={"kernel": body or "K5", "grid": grid},
                 got=got, want=want)
            fail(f"{body or 'K5'} batch disagrees with span_segmin_scan at "
                 f"grid {grid}")
    if [w[-2] for w in want] != [M32] * 3 or want[2][-1] == M32:
        fail("K5 batch: the empty-window segment is not the sentinel, or "
             "the segment beside it lost its valid row")
    jobs = {"mice": mice_jobs(dev),
            "classes": [(NonceSearcher(m, device=dev), lo, hi) for m, lo, hi
                        in zip(MICE_DATA * 2, [0] + [10 ** d + 17 * d
                                                      for d in range(1, 9)],
                               [7] + [10 ** d + 17 * d + 50_000
                                      for d in range(1, 9)])]}
    searcher_kw = {} if body is None else {"peel": True,
                                           "hoist": body == "K4"}
    for name, entries in jobs.items():
        for grid in (None, 37):
            part = [(NonceSearcher(s.data, device=dev, grid=grid,
                                   **searcher_kw), lo, hi)
                    for s, lo, hi in entries]
            s0 = part[0][0]
            got = s0.finalize_batch(s0.dispatch_batch(part))
            per_job = [s.search(lo, hi) for s, lo, hi in part]
            if got != per_job:
                fail(f"{body or 'K5'} {name} batch at grid {grid}: {got} != "
                     f"per-job search {per_job}")
    return {"rows": len(rows), "segments": seg[-1] + 1,
            "rows_by_variant": variants_of((r[6], r[7], r[1]) for r in rows),
            "lanes": sum(r[5] for r in rows), "max_abs_err": max_err,
            "searcher_batches": {k: len(v) for k, v in jobs.items()}}


def int32_words(values) -> "torch.Tensor":
    """uint32 values (nested lists or numpy) as an int32 tensor of their bit
    patterns, on the CPU."""
    import numpy as np
    import torch
    return torch.from_numpy(np.asarray(values, dtype=np.int64)
                            .astype(np.uint32).view(np.int32))


#: The seed of the mesh fold cases.
MESH_SEED = 445
#: The rem x k windows whose four-way shard searches are held to the plain
#: scan of the whole window: 1-block tails (0, 9), (31, 5), 2-block ones
#: (56, 9), (63, 9).
MESH_WINDOWS = ((0, 9), (31, 5), (56, 9), (63, 9))
#: The block base of those checks: the nonces' low word wraps past lane
#: 1,000.
MESH_BASE = (1 << 32) - 1_000


def mesh_fold_cases() -> list:
    """``(until, rows, carry, base)`` cases of the mesh folds: n = 1 to 4
    rows with hash and index ties and all-ones rows (an empty shard),
    found and not-found carries, bases whose low word wraps."""
    import numpy as np
    rng = np.random.default_rng(MESH_SEED)
    cases = []
    for n in (1, 2, 3, 4):
        for c in range(12):
            until = c % 2 == 1
            rows = np.empty((n, 5), dtype=np.int64)
            rows[:, 2] = rng.choice([0, 7, M32], size=n)
            rows[:, 3] = rng.choice([1, 2, M32], size=n)
            rows[:, 4] = rng.choice([5, 6, M32 - 1], size=n)
            rows[:, 1] = np.where(rng.random(n) < 0.5,
                                  rng.integers(0, 10 ** 9, size=n), M32)
            rows[:, 0] = rows[:, 1] != M32
            if c % 3 == 0:
                rows[-1] = [0, M32, M32, M32, M32]
            if until:
                carry = [0, M32, M32] + [M32] * 4 + [0]
            else:
                carry = [M32] * 4 + [0]
            if c % 4 >= 2:   # a carry that has seen (until: found) some
                carry = [int(x) for x in rng.choice([0, 3, M32 - 1],
                                                    size=len(carry))]
                carry[-1] = 1
                if until:
                    carry[0] = int(c % 8 >= 4)
            base = (int(rng.integers(0, 4)) << 32) | int(
                rng.choice([0, M32 - 3, 123]))
            cases.append((until, rows if until else rows[:, 2:], carry,
                          base))
    return cases


def hit_windows(lo_i: int, hi_i: int, keys):
    """A four-way mesh window inside ``[lo_i, hi_i]`` whose shard 2 holds
    a lane with a lower hash than every lane of shards 0 and 1 (``keys``:
    the 64-bit hashes of ``lo_i`` onwards, numpy): ``(lo, hi)``, the
    lowest-hash lane among the first 50 candidates placed mid-shard 2
    with shards of at least 100 lanes; None for a window too narrow."""
    import numpy as np
    for x in (int(i) + lo_i for i in np.argsort(keys, kind="stable")[:50]):
        m = min((x - lo_i) * 2 // 5, (hi_i - x + 1) * 2 // 3, 1 << 18)
        lo = x - 2 * m - m // 2
        if m >= 100 and keys[lo - lo_i:x - m // 2 - lo_i].min() > \
                keys[x - lo_i]:
            return lo, lo + 4 * m - 1
    return None


def check_mesh(dev) -> dict:
    """K6's mesh bodies against their plain versions: the two mesh folds
    on :func:`mesh_fold_cases`; the per-shard searches over four-way
    ``device_windows`` of the :data:`MESH_WINDOWS` cases, as on one card:
    the arg-min shards merged by the fold kernel, against the plain scan
    and fold of the whole window; the until shards, sharing the card's
    lowest-hit word, row by row against the plain until scan given the
    lowest hit so far (found and f_idx always, the arg-min words when
    found is 0), over a window of :func:`hit_windows` with the first hit
    in shard 0, in shard 2 only (lanes of shard 3 qualify too) and
    nowhere, and after an earlier block's hit (no lane work, the carry as
    it was): each shard's handed-out runs read from its counter word,
    none for a shard launched above a stored hit, and the carry after
    the fold kernel equal both to the plain fold of the plain rows and
    to the plain until scan of the whole window, folded."""
    import torch
    from distributed_bitcoinminer_tpu_torch.ops import (search, searchop,
                                                        sha256_cuda)
    from distributed_bitcoinminer_tpu_torch.parallel.mesh_search import (
        fold_rows_argmin, fold_rows_until)
    from distributed_bitcoinminer_tpu_torch.parallel.partition import \
        device_windows
    max_err, folds = 0, 0

    def held(got, want, what, **ctx):
        nonlocal max_err
        err = max(abs(a - b) for a, b in zip(got, want))
        max_err = max(max_err, err)
        if err:
            emit("kernel", failed={"kernel": what, **ctx}, got=list(got),
                 want=list(want))
            fail(f"{what} disagrees with its plain version: {ctx}")

    for until, rows, carry, base in mesh_fold_cases():
        kernel_carry = int32_words(carry).to(dev)
        fold = sha256_cuda.mesh_fold_until if until else \
            sha256_cuda.mesh_fold_argmin
        fold(int32_words(rows).to(dev), kernel_carry, base, device=dev)
        plain = (fold_rows_until if until else fold_rows_argmin)(
            torch.tensor(carry), torch.from_numpy(rows), base)
        held(words(kernel_carry), words(plain), "K6mesh fold", until=until,
             rows=rows.tolist(), carry=carry, base=base)
        folds += 1

    def quad(lo, hi):
        _, lo_d, hi_d, _ = device_windows(lo, hi, 4, 1)
        return [(int(a), int(b)) for a, b in zip(lo_d, hi_d) if a <= b]

    shards = []
    for rem, k, _, mid, tmpl, i0, n, lo_i, hi_i in kernel_windows():
        if (rem, k) not in MESH_WINDOWS:
            continue
        ctx = {"rem": rem, "k": k}
        wins = quad(lo_i, hi_i)
        # The arg-min chain's block.
        hi_w, lo_w, idx_w = words(search.span_scan(
            mid, tmpl, lo_i, lo_i, hi_i, hi_i - lo_i + 1, rem=rem, k=k,
            device=dev))
        want = words(searchop.fold_argmin(
            searchop.carry_init(), hi_w, lo_w, idx_w, MESH_BASE >> 32,
            MESH_BASE & M32))
        rows = torch.full((4, 3), -1, dtype=torch.int32, device=dev)
        for s, (a, b) in enumerate(wins):
            sha256_cuda.sha256_argmin(mid, tmpl, a, a, b, b - a + 1,
                                      rem=rem, k=k, device=dev, out=rows[s])
        carry = search.devloop_carry(searchop.ARGMIN_OP, dev)
        sha256_cuda.mesh_fold_argmin(rows, carry, MESH_BASE, device=dev)
        held(words(carry), want, "K6mesh argmin shards", **ctx)
        # The until chain's block, on a window with the lowest hash of
        # shards 0-2 in shard 2 (a window too narrow for one: the whole,
        # with the target only its arg-min lane meets).
        keys = lane_hashes(mid, tmpl, lo_i, hi_i - lo_i + 1, rem, k, dev)
        placed = hit_windows(lo_i, hi_i, keys)
        w_lo, w_hi = placed or (lo_i, hi_i)
        hwins = quad(w_lo, w_hi)
        mins = [words(search.span_scan(mid, tmpl, a, a, b, b - a + 1,
                                       rem=rem, k=k, device=dev))
                for a, b in hwins]
        key = [m[0] << 32 | m[1] for m in mins]
        cases = {"hit_in_shard_0": key[0] + 1, "hit_in_shard_2": key[2] + 1,
                 "no_hit": 0, "after_hit": key[0] + 1} if placed else {
            "hit_at_arg_min": int(keys.min()) + 1, "no_hit": 0,
            "after_hit": 1}
        handed_by_case = {}
        for name, target in cases.items():
            t_hi, t_lo = target >> 32, target & M32
            carry = search.devloop_carry(searchop.UNTIL_OP, dev)
            if name == "after_hit":
                carry[0] = 1
            before = words(carry)
            hit = torch.full((2,), -1, dtype=torch.int32, device=dev)
            rows = torch.full((4, 5), -1, dtype=torch.int32, device=dev)
            rows[:, 0] = 0   # an empty shard's row
            plain_rows, lowest, handed = [], M32, []
            for s, (a, b) in enumerate(hwins):
                stored = lowest
                sha256_cuda.sha256_until_shard(
                    mid, tmpl, carry, a, a, b, b - a + 1, t_hi, t_lo,
                    rem=rem, k=k, device=dev, hit=hit, first=s == 0,
                    out=rows[s])
                handed.append(M32 - words(hit)[1])
                row = words(rows[s])
                if name == "after_hit":
                    plain = (0, M32, M32, M32, M32)
                else:
                    plain = words(search.span_until_scan(
                        mid, tmpl, a, a, b, b - a + 1, t_hi, t_lo, rem=rem,
                        k=k, device=dev, lowest=lowest))
                    lowest = plain[1]
                plain_rows.append(plain)
                cmp = 2 if plain[0] else 5
                held(row[:cmp], plain[:cmp], "K6mesh until shard", **ctx,
                     case=name, shard=s)
                runs = sha256_cuda.runs(a, a, b, b - a + 1)
                if (stored < a or name == "after_hit") and handed[-1]:
                    fail(f"a mesh until shard launched above a stored hit "
                         f"took {handed[-1]} runs ({ctx}, {name}, shard "
                         f"{s})")
                if stored == M32 and name != "after_hit" and not plain[0] \
                        and handed[-1] < runs:
                    fail(f"a mesh until shard with no hit took "
                         f"{handed[-1]} of its {runs} runs ({ctx}, {name})")
            sha256_cuda.mesh_fold_until(rows, carry, MESH_BASE, device=dev)
            if name == "after_hit":
                want = whole = before
            else:
                want = words(fold_rows_until(
                    torch.tensor(before), torch.tensor(plain_rows),
                    MESH_BASE))
                # The whole window's plain until scan, with no shared
                # word: the answer the shards must reach.
                whole = words(searchop.fold_until(
                    searchop.until_carry_init(), *words(
                        search.span_until_scan(
                            mid, tmpl, w_lo, w_lo, w_hi, w_hi - w_lo + 1,
                            t_hi, t_lo, rem=rem, k=k, device=dev))[1:],
                    MESH_BASE >> 32, MESH_BASE & M32))
            cmp = 3 if want[0] else 8
            held(words(carry)[:cmp], want[:cmp],
                 "K6mesh until shards, rows folded", **ctx, case=name)
            held(words(carry)[:cmp], whole[:cmp],
                 "K6mesh until shards, whole window", **ctx, case=name)
            if name != "no_hit" and not words(carry)[0]:
                fail(f"the mesh until shards missed the hit ({ctx}, {name})")
            handed_by_case[name] = handed
        firsts = {name: words(search.span_until_scan(
            mid, tmpl, w_lo, w_lo, w_hi, w_hi - w_lo + 1, t >> 32, t & M32,
            rem=rem, k=k, device=dev))[1] for name, t in cases.items()
            if name.startswith("hit")}
        if placed and not (
                hwins[0][0] <= firsts["hit_in_shard_0"] <= hwins[0][1]
                and hwins[2][0] <= firsts["hit_in_shard_2"] <= hwins[2][1]
                and handed_by_case["hit_in_shard_2"][3] == 0
                and handed_by_case["hit_in_shard_0"][1:] == [0, 0, 0]):
            fail(f"the mesh until windows do not place the hits ({ctx}): "
                 f"{firsts}, {hwins}, {handed_by_case}")
        shards.append({"rem": rem, "k": k, "nblocks": int(tmpl.shape[0]),
                       "lanes": hi_i - lo_i + 1, "windows": wins,
                       "until_windows": hwins, "first_hits": firsts,
                       "handed_runs": handed_by_case})
    return {"folds": folds, "shard_cases": shards, "max_abs_err": max_err}


def check_k7(dev) -> dict:
    """K7 over one full wave against its plain version on the card, both
    timed there."""
    from distributed_bitcoinminer_tpu_torch.ops import alu_probe
    wave = alu_probe.wave(dev)
    got = alu_probe.alu_probe(wave, device=dev)
    want = alu_probe.alu_probe_plain(got.numel(), device=dev)
    err = int(((got.to(want.dtype) & M32) - want).abs().max())
    if err:
        fail(f"K7 disagrees with its plain version (max error {err})")
    return {"grid": wave, "lanes": got.numel(), "iters": alu_probe.ITERS,
            "max_abs_err": err,
            "ms": cuda_ms(lambda: alu_probe.alu_probe(wave, device=dev), 5),
            "plain_ms": cuda_ms(lambda: alu_probe.alu_probe_plain(
                got.numel(), device=dev), 1)}


def phase_kernel() -> dict:
    """Every kernel against its plain version; K3 and K4 in every shape:
    the single arg-min and until launches, the chains and the batch."""
    import torch
    dev = torch.device("cuda", 0)
    info = {"K1": check_k1(dev), "K2": check_k2(dev), "K5": check_k5(dev),
            "K6": check_k6(dev), "K6mesh": check_mesh(dev),
            "K7": check_k7(dev)}
    for kern, _, _ in PEELED:
        shapes = {"argmin": check_k1(dev, kern),
                  "until": check_k2(dev, kern),
                  "chains": check_k6(dev, kern),
                  "batch": check_k5(dev, kern)}
        info[kern] = {**shapes, "max_abs_err": max(
            v["max_abs_err"] for v in shapes.values())}
    torch.cuda.synchronize()
    emit("kernel", **info)
    return info


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for_line(log_path: str, text: str, proc, timeout: float = 300):
    """Poll ``log_path`` until it holds ``text``; fail if ``proc`` exits
    or the time runs out."""
    deadline = time.monotonic() + timeout
    while True:
        with open(log_path, errors="replace") as f:
            if text in f.read():
                return
        if proc.poll() is not None or time.monotonic() > deadline:
            fail(f"{text!r} never appeared in {log_path}")
        time.sleep(0.1)


def read_counts(log_path: str) -> dict:
    """The miner's last ``counts`` log line (JSON after the marker)."""
    last = {}
    with open(log_path, errors="replace") as f:
        for line in f:
            if "miner counts " in line:
                last = json.loads(line.split("miner counts ", 1)[1])
    return last


KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K6mesh")


def launches_of(counts: dict) -> dict:
    return dict(counts.get("kernel_launches", dict.fromkeys(KERNELS, 0)))


#: The emitter's cadence on the servers whose live series the metrics
#: check reads (the mice, lease and verification paths: series that
#: retire with their tenant, or move back once a quarantine lifts); every
#: other process logs its snapshot each 30 s and, at its exit, its final
#: one (a miner on SIGTERM too).
METRICS_ENV = {"DBMT_METRICS_INTERVAL_S": "0.1"}
#: The scheduler's pool rate against a miner's own nonces/s EWMA: within
#: this factor either way (the prediction PERF.md holds for this check).
RATE_FACTOR = 3.0
#: A miner's model counters where its launch counts restart at 0.
RESTART_LINE = "model counts at the launch counts' restart "


def metric_snapshots(log_path: str) -> list:
    """Every snapshot line a process's metrics emitter logged, oldest
    first (a final one last, once the process has exited)."""
    snaps = []
    with open(log_path, errors="replace") as f:
        for line in f:
            if '"event": "metrics"' in line:
                snaps.append(json.loads(line[line.index("{"):]))
    return snaps


def final_snapshot(log_path: str, what: str) -> dict:
    """The snapshot ``what`` logged at its exit."""
    snaps = metric_snapshots(log_path)
    if not snaps or not snaps[-1]["final"]:
        fail(f"metrics: {what} logged no final snapshot ({log_path})")
    return snaps[-1]["snapshot"]


def restart_counts(log_path: str) -> dict:
    """A miner's model counters at its last launch-count restart."""
    last = None
    with open(log_path, errors="replace") as f:
        for line in f:
            if RESTART_LINE in line:
                last = json.loads(line.split(RESTART_LINE, 1)[1])
    if last is None:
        fail(f"metrics: no {RESTART_LINE.strip()!r} line in {log_path}")
    return last


#: R2's message: 60 characters, so the prefix tail is 61 bytes and every
#: nonce's digits run into a second tail block.
R2_DATA = "a sixty-character message whose nonce digits cross a block.."
ARGMIN_REQUESTS = (("R1", "cmu440", (1 << 26) - 1),
                   ("R2", R2_DATA, 10 ** 8 - 1),
                   ("R3", "cmu440", (1 << 32) - 1),
                   ("R1 again", "cmu440", (1 << 26) - 1),
                   ("mouse", "cmu440", 10 ** 5 - 1))
#: The mice's messages: three have 2-block tails at 6 or 7 digits.
MICE_DATA = ("cmu440", "mouse", "a" * 20, "bee", R2_DATA,
             "a fifty-character message; its digits stay in one.",
             "m" * 56, "tenant seven")
#: R4's target: about one nonce in 10^8 qualifies.
R4_TARGET = (1 << 64) // 10 ** 8
UNTIL_REQUESTS = (("R4", "cmu440", (1 << 32) - 1, R4_TARGET),
                  ("R5", "cmu440", (1 << 26) - 1, 1))
#: The ranges the two miners scan for R4: the scheduler splits [0, 2^32)
#: evenly, and each miner scans its chunk's upper bound too.
R4_CHUNKS = ((0, 1 << 31), (1 << 31, 1 << 32))


class Cluster:
    """The port's server and miners as subprocesses through their CLIs,
    logging under ``outdir``; stopped, all of them, on exit. A miner runs
    on card 0 alone unless its own environment names a mesh
    (``DBMT_MESH_DEVICES``), so the single-device paths stay so on a box
    with several cards. A server runs in a directory of its own,
    ``e2e_<name>/``, where it logs to ``log.txt`` and, when it stops,
    exports its request traces (``trace.json`` and ``trace.json.jsonl``,
    ``DBMT_TRACE_EXPORT``); its standard output goes to
    ``e2e_<name>.log``."""

    def __init__(self, outdir: str):
        self.outdir = outdir
        self.port = free_port()
        self.hostport = f"127.0.0.1:{self.port}"
        # No random audits (the server's default, 2% of the arg-min
        # chunks): they would add launches that no path's check expects.
        # The verification path turns them on for its own server. No
        # result cache: it would answer the paths' repeated requests (R1
        # again, the lease path's second R3, the verification path's last
        # R3) without the miners, which those requests are there to
        # measure. The sched path turns it on for its own servers.
        self.env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                        + os.environ.get("PYTHONPATH", ""),
                        DBMT_MESH_DEVICES="cuda:0", DBMT_AUDIT_P="0",
                        DBMT_CACHE="0")
        self.procs, self.handles, self.logs, self.outs = [], [], {}, {}

    def spawn(self, name: str, module: str, args: list,
              env: dict | None = None) -> str:
        """Start one of the package's CLIs logging to its own file;
        returns the log (a server's ``log.txt``)."""
        argv = ["-m", f"{PKG}.apps.{module}", *args]
        if module != "server":
            return self.launch(name, argv, env)
        cwd = server_dir(self.outdir, name)
        os.makedirs(cwd, exist_ok=True)
        for old in glob.glob(os.path.join(cwd, "*")):
            os.remove(old)
        open(os.path.join(cwd, "log.txt"), "w").close()
        self.launch(name, argv, {"DBMT_TRACE_EXPORT": os.path.join(
            cwd, "trace.json"), **(env or {})}, cwd=cwd)
        self.logs[name] = os.path.join(cwd, "log.txt")
        return self.logs[name]

    def launch(self, name: str, argv: list, env: dict | None = None,
               cwd: str | None = None) -> str:
        log = self.logs[name] = self.outs[name] = os.path.join(
            self.outdir, f"e2e_{name}.log")
        self.handles.append(open(log, "w"))
        self.procs.append(subprocess.Popen(
            [sys.executable, *argv], cwd=cwd or self.outdir,
            env={**self.env, **(env or {})},
            stdout=self.handles[-1], stderr=subprocess.STDOUT))
        return log

    def spawn_fault_miner(self, name: str, mode: str) -> str:
        """A miner whose searcher fails in ``mode`` (:func:`fault_miner`)."""
        return self.launch(name, [os.path.abspath(__file__),
                                  "--fault-miner", mode, self.hostport])

    def start(self, name: str, module: str, args: list, ready: str,
              env: dict | None = None) -> str:
        """Start one process and wait until its log shows ``ready`` (the
        server listens; a miner joins after warming the device up, so
        requests time requests, not process start). Returns its log."""
        log = self.spawn(name, module, args, env)
        wait_for_line(self.outs[name], ready, self.procs[-1])
        return log

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for p in self.procs[::-1]:
            p.terminate()
        for p in self.procs[::-1]:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for fh in self.handles:
            fh.close()
        return False


def server_dir(outdir: str, name: str) -> str:
    """The working directory of the server ``name`` of a path."""
    return os.path.join(outdir, f"e2e_{name}")


def exported_traces(outdir: str, name: str) -> tuple:
    """The server ``name``'s exported traces, once it has stopped: its
    trace dicts and its Perfetto document."""
    base = os.path.join(server_dir(outdir, name), "trace.json")
    if not os.path.exists(base):
        fail(f"server {name} exported no traces ({base})")
    with open(base + ".jsonl") as f:
        dicts = [json.loads(line) for line in f if line.strip()]
    with open(base) as f:
        return dicts, json.load(f)


def adapt_state(log_path: str) -> dict | None:
    """The scheduler's last ``scheduler adapt`` line (its controllers'
    values), or None when it logged none (the plane off)."""
    last = None
    with open(log_path, errors="replace") as f:
        for line in f:
            if "scheduler adapt " in line:
                last = json.loads(line.split("scheduler adapt ", 1)[1])
    return last


def check_adapt_bounds(where: str, state: dict | None) -> None:
    """A mounted adapt plane's values inside their controllers' floors
    and ceilings (``apps/adapt.py``'s class constants)."""
    from distributed_bitcoinminer_tpu_torch.apps.adapt import (
        AdmissionController, ChunkSizeController, CoalesceWindowController)
    bounds = {"chunk_s": (ChunkSizeController.FLOOR_S,
                          ChunkSizeController.CEIL_S),
              "small_s": (CoalesceWindowController.FLOOR_S,
                          CoalesceWindowController.CEIL_S),
              "admit_rate": (AdmissionController.RATE_FLOOR,
                             AdmissionController.RATE_CEIL)}
    if not state:
        fail(f"{where}: the adapt plane logged no state")
    for key, (lo, hi) in bounds.items():
        if key in state and not lo <= state[key] <= hi:
            fail(f"{where}: adapt {key} {state[key]} outside [{lo}, {hi}]")


#: The scheduler's line for a chunked activation's plan, and for an
#: answer.
PLAN_LINE = re.compile(r"request (\d+) ('.*'|\".*\") \[(\d+), (\d+)\] "
                       r"chunked: (\d+) chunks of (\d+) nonces at chunk_s "
                       r"(\S+), pool rate (\S+)$")
ANSWER_LINE = re.compile(r"request (\d+) served in ")


def check_chunk_plans(run: dict) -> dict:
    """The chunk seconds reach the planner and the miners. Each chunked
    activation of a mice run was planned from the chunk seconds in force
    (the adapt plane's last logged ``chunk_s``; the server's
    ``DBMT_QOS_CHUNK_S`` before the plane's first line or with the plane
    off), its chunk count and size are the planner's for its logged pool
    rate, and every chunk of an answered plan of several chunks was
    served by a miner with the planned bounds. Returns the plans'
    counts: all, of several chunks, planned after the chunk controller's
    first move, and both."""
    from distributed_bitcoinminer_tpu_torch.utils.config import QosParams
    max_chunks = QosParams().max_chunks
    in_force = float(MICE_SERVER_ENV["DBMT_QOS_CHUNK_S"])
    moved = False
    plans, answered = [], set()
    with open(run["server_log"], errors="replace") as f:
        for line in f:
            if "scheduler adapt " in line:
                state = json.loads(line.split("scheduler adapt ", 1)[1])
                in_force = state.get("chunk_s", in_force)
                moved = moved or state.get("chunk_adjustments", 0) > 0
            elif m := PLAN_LINE.search(line.rstrip("\n")):
                plans.append({"job": int(m[1]),
                              "data": ast.literal_eval(m[2]),
                              "lower": int(m[3]), "upper": int(m[4]),
                              "n": int(m[5]), "size": int(m[6]),
                              "chunk_s": float(m[7]),
                              "rate": ast.literal_eval(m[8]),
                              "in_force": in_force, "after_move": moved})
            elif m := ANSWER_LINE.search(line):
                answered.add(int(m[1]))
    served = {tuple(c) for c in served_chunks(run["miner_logs"])}
    for p in plans:
        total = p["upper"] - p["lower"]
        if p["rate"]:
            n = -(-total // max(1, int(p["rate"] * p["chunk_s"])))
        else:
            n = 2       # cold: an even split over the path's two miners
        n = max(1, min(max_chunks, n, total))
        if round(p["chunk_s"], 6) != p["in_force"] \
                or (p["n"], p["size"]) != (n, total // n):
            fail(f"{run['tag']}: a plan not made from the chunk seconds in "
                 f"force ({p['in_force']}): {p}, expected {n} chunks")
        if p["n"] < 2 or p["job"] not in answered:
            continue
        base, size, rem = p["lower"], *divmod(total, p["n"])
        for i in range(p["n"]):
            step = size + (1 if i < rem else 0)
            if (p["data"], base, base + step) not in served:
                fail(f"{run['tag']}: planned chunk {p['data']!r} [{base}, "
                     f"{base + step}] of request {p['job']} not served")
            base += step
    multi = [p for p in plans if p["n"] >= 2]
    return {"plans": len(plans), "multi_chunk": len(multi),
            "after_move": sum(p["after_move"] for p in plans),
            "multi_chunk_after_move": sum(p["after_move"] for p in multi)}


def timed(name: str, data: str, max_nonce: int, submit_fn) -> dict:
    t0 = time.monotonic()
    res = submit_fn()
    wall = time.monotonic() - t0
    if res is None:
        fail(f"{name}: client disconnected")
    nonces = max_nonce + 2          # the system scans [0, max+1]
    return {"request": name, "data": data, "max_nonce": max_nonce,
            "hash": res[0], "nonce": res[1], "seconds": wall,
            "nonces_per_s": nonces / wall}


def cli_submit(cluster: Cluster, data: str, max_nonce: int, target: int):
    """The request through the client CLI with its fifth argument."""
    out = subprocess.run(
        [sys.executable, "-m", f"{PKG}.apps.client", cluster.hostport, data,
         str(max_nonce), str(target)], capture_output=True, text=True,
        env=cluster.env, cwd=cluster.outdir, timeout=300)
    m = re.fullmatch(r"Result (\d+) (\d+)", out.stdout.strip())
    if out.returncode != 0 or m is None:
        fail(f"client CLI: rc {out.returncode}, {out.stdout!r} "
             f"{out.stderr[-2000:]!r}")
    return int(m.group(1)), int(m.group(2))


def start_miners(c: Cluster, names: list, envs: list) -> list:
    """Start one miner per name on ``cuda``, all at once (each pays its
    process start and warm-up beside the others), wait until every one
    has joined, and check that each one's launch counts start at 0."""
    logs = [c.spawn(name, "miner", [c.hostport, "--device", "cuda"], env)
            for name, env in zip(names, envs)]
    for name, log, proc in zip(names, logs, c.procs[-len(names):]):
        wait_for_line(log, "joined ", proc)
        if read_counts(log):
            fail(f"{name}'s counts were not 0 before its path: "
                 f"{read_counts(log)}")
    return logs


def sum_launches(by_miner: dict) -> dict:
    """Launches per kernel summed over a path's miners."""
    return {k: sum(c[k] for c in by_miner.values()) for k in KERNELS}


def served_chunks(miner_logs: list) -> list:
    """The chunks ``[data, lower, upper]`` that the miners served one at a
    time (a coalesced batch logs another line), from their ``served``
    log lines."""
    pattern = re.compile(r" served ('.*'|\".*\") \[(\d+), (\d+)\] in ")
    chunks = []
    for log in miner_logs:
        with open(log, errors="replace") as f:
            for line in f:
                m = pattern.search(line)
                if m:
                    chunks.append([ast.literal_eval(m.group(1)),
                                   int(m.group(2)), int(m.group(3))])
    return chunks


def path_launches(miner_logs: list) -> dict:
    """The launches per kernel that the miners made on one path, read
    after its last request (each miner logs its counts per chunk)."""
    time.sleep(0.5)
    total = dict.fromkeys(KERNELS, 0)
    for log in miner_logs:
        for kern, n in launches_of(read_counts(log)).items():
            total[kern] += n
    return total


#: The mice path: a warm-up that gives each miner a throughput sample
#: (the scheduler's rate window is 0.5 s), then the elephant, about one
#: card-second over two miners, and while it runs 64 mice of 10^5-10^6
#: nonces over the 8 messages of MICE_DATA from 8 client connections, each
#: connection sending its 8 mice at once.
MICE_WARM_UP = ("warm-up", (1 << 33) - 1)
ELEPHANT = ("cmu440", (1 << 34) - 1)
MICE_TENANTS, MICE_PER_TENANT, MICE_SEED = 8, 8, 440
#: The server's QoS settings: a request above 0.1 s of the pool's work
#: while any is in flight is chunked, in chunks of 0.05 s.
MICE_SERVER_ENV = {"DBMT_QOS_WHOLESALE_S": "0.1", "DBMT_QOS_CHUNK_S": "0.05"}
#: The warm-pool mice path: after the warm-up an elephant of its own, about
#: five card-seconds, is served until the adapt plane's chunk controller
#: has moved (its first sweeps), and only then come the elephant and the
#: mice of the mice path, while it is still served.
WARM_ELEPHANT = ("warm pool", (1 << 36) - 1)
#: The cross-card drill's job: the elephant's data over 2^36 nonces, about
#: two seconds on a pod of four H100s, so that a follower killed as the job
#: starts dies mid-job.
CROSS_DRILL_JOB = ("cmu440", (1 << 36) - 1)


def mice_traffic() -> list:
    """Per connection, its mice ``[(data, max_nonce), ...]`` (seeded)."""
    import numpy as np
    rng = np.random.default_rng(MICE_SEED)
    sizes = rng.integers(10 ** 5, 10 ** 6, size=(MICE_TENANTS,
                                                 MICE_PER_TENANT))
    return [[(MICE_DATA[(c + j) % len(MICE_DATA)], int(sizes[c, j]))
             for j in range(MICE_PER_TENANT)] for c in range(MICE_TENANTS)]


async def tenant_mice(hostport: str, mice: list) -> dict:
    """One client connection: write every mouse at once, then read the
    Results (a tenant's requests are served in order). Returns
    ``{"results": [(hash, nonce, seconds from the writes), ...],
    "disconnected": bool}`` (the server shed the tenant and closed its
    connection before every Result came)."""
    from distributed_bitcoinminer_tpu_torch.bitcoin.message import (
        Message, MsgType, new_request)
    from distributed_bitcoinminer_tpu_torch.lsp.client import \
        new_async_client
    from distributed_bitcoinminer_tpu_torch.lsp.errors import LspError
    client = await new_async_client(hostport)
    t0 = time.monotonic()
    for data, max_nonce in mice:
        client.write(new_request(data, 0, max_nonce).to_json())
    out, lost = [], False
    try:
        while len(out) < len(mice):
            msg = Message.from_json(await client.read())
            if msg.type == MsgType.RESULT:
                out.append((msg.hash, msg.nonce, time.monotonic() - t0))
    except LspError:
        lost = True
    finally:
        await client.close()
    return {"results": out, "disconnected": lost}


async def chunk_moved(log_path: str, served) -> None:
    """Wait until the server's chunk controller has moved (its ``scheduler
    adapt`` line counts an adjustment); fails if the task ``served`` ends
    first."""
    import asyncio
    while not served.done():
        state = adapt_state(log_path)
        if state and state.get("chunk_adjustments", 0) > 0:
            return
        await asyncio.sleep(0.1)
    fail(f"the chunk controller did not move while {WARM_ELEPHANT} was "
         f"served ({log_path})")


def run_mice(outdir: str, coalesce: bool, miner_env: dict | None = None,
             tag: str | None = None, adapt: bool | None = None,
             admit: bool = False, warm: bool = False,
             server_env: dict | None = None) -> dict:
    """The mice path on a new server and two miners, all with
    ``DBMT_COALESCE`` on or off (the miners also with ``miner_env``), the
    server's adapt plane on or off (``DBMT_ADAPT``; None: its default,
    on), with its admission controller when ``admit``
    (``DBMT_ADAPT_ADMIT=1``, the JAX package's default): the warm-up,
    then, when ``warm``, :data:`WARM_ELEPHANT` until the chunk controller
    has moved, then the elephant and the mice. Returns the answers, the
    request seconds, the tenants shed (their connections closed), the
    miners' launches and coalesced dispatches, the adapt plane's last
    values, and the server's and the miners' logs. ``server_env`` adds to
    the server's environment."""
    import asyncio

    from distributed_bitcoinminer_tpu_torch.apps.client import submit
    tag = tag or (("mice" if coalesce else "mice_per_chunk")
                  + ("_adapt" if adapt else "") + ("_admit" if admit else ""))
    env = {"DBMT_COALESCE": "1" if coalesce else "0"}
    server_env = {**MICE_SERVER_ENV, **METRICS_ENV, **env,
                  **(server_env or {})}
    if adapt is not None:
        server_env["DBMT_ADAPT"] = "1" if adapt else "0"
    if admit:
        server_env["DBMT_ADAPT_ADMIT"] = "1"
    traffic = mice_traffic()
    with Cluster(outdir) as c:
        server_log = c.start(f"{tag}_server", "server", [str(c.port)],
                             "Server listening on port", env=server_env)
        names = [f"{tag}_miner", f"{tag}_miner2"]
        logs = [c.spawn(n, "miner", [c.hostport, "--device", "cuda"],
                        {**env, **(miner_env or {})}) for n in names]
        for name, log, proc in zip(names, logs, c.procs[-2:]):
            wait_for_line(log, "joined ", proc)
            if read_counts(log):
                fail(f"{name}'s counts were not 0 before its path")
        warm_up = timed("warm-up", *MICE_WARM_UP, lambda: asyncio.run(
            asyncio.wait_for(submit(c.hostport, *MICE_WARM_UP), 300)))

        async def both():
            pool = None
            if warm:
                pool = asyncio.create_task(submit(c.hostport,
                                                  *WARM_ELEPHANT))
                await chunk_moved(server_log, pool)
            t0 = time.monotonic()
            elephant = asyncio.create_task(submit(c.hostport, *ELEPHANT))
            await asyncio.sleep(0.3)
            mice = await asyncio.gather(*(tenant_mice(c.hostport, m)
                                          for m in traffic))
            res = await elephant
            return res, time.monotonic() - t0, mice, \
                (await pool if pool else None)
        el, el_s, mice, pool = asyncio.run(asyncio.wait_for(both(), 300))
        time.sleep(0.5)
        counts = {log: read_counts(log) for log in logs}
        adapt_values = adapt_state(server_log)
        with open(server_log, errors="replace") as f:
            sheds = [[kind, int(t), 1 + int(sib)]
                     for kind, t, sib in SHED_LINE.findall(f.read())]
    if el is None or warm and pool is None:
        fail(f"{tag}: an elephant's client disconnected")
    launches = dict.fromkeys(KERNELS, 0)
    for log in logs:
        for kern, n in launches_of(counts[log]).items():
            launches[kern] += n
    dispatches = sum(counts[log].get("coalesced_dispatches", 0)
                     for log in logs)
    chunks = sum(counts[log].get("coalesced_chunks", 0) for log in logs)
    secs = sorted(r[2] for t in mice for r in t["results"])
    return {"coalesce": coalesce, "miner_env": miner_env or {},
            "tag": tag, "adapt_env": adapt, "admit": admit,
            "adapt": adapt_values, "warm_up": warm_up,
            "warm_elephant": {"data": WARM_ELEPHANT[0],
                              "max_nonce": WARM_ELEPHANT[1],
                              "hash": pool[0], "nonce": pool[1]}
            if warm else None,
            "server_log": server_log, "miner_logs": logs,
            "elephant": {"data": ELEPHANT[0], "max_nonce": ELEPHANT[1],
                         "hash": el[0], "nonce": el[1], "seconds": el_s},
            "mice": [[data, mx, h, n, sec] for t, m in zip(mice, traffic)
                     for (data, mx), (h, n, sec) in zip(m, t["results"])],
            "mice_answered": len(secs),
            "tenants_disconnected": sum(t["disconnected"] for t in mice),
            "shed_lines": sheds,
            "mice_p50_s": secs[len(secs) // 2] if secs else None,
            "mice_p99_s": secs[min(len(secs) - 1, int(0.99 * len(secs)))]
            if secs else None,
            "coalesced_dispatches": dispatches,
            "coalesced_chunks": chunks,
            "mean_width": chunks / dispatches if dispatches else 0.0,
            "launches": launches}


def check_mice(runs: list, dev) -> None:
    """Every answered mouse of every run equal to the plain scan on the
    card; the elephants equal in every run to a direct search at 1,001
    blocks, after the hashlib claim check; K5 launched on the coalescing
    run; no tenant shed unless the run mounts the admission controller,
    and then the shed tenants exactly those disconnected."""
    from distributed_bitcoinminer_tpu_torch.bitcoin.hash import hash_op
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
    plain = {}
    for run in runs:
        for data, mx, h, n, _ in run["mice"]:
            if (data, mx) not in plain:
                plain[data, mx] = plain_search(
                    NonceSearcher(data, device=dev), 0, mx + 1)
            if (h, n) != plain[data, mx]:
                fail(f"mouse {data!r} {mx}: {(h, n)} != plain "
                     f"{plain[data, mx]} (coalesce {run['coalesce']})")
    direct = {}
    for run in runs:
        for el in (run["elephant"], run["warm_elephant"]):
            if el is None:
                continue
            data, mx = el["data"], el["max_nonce"]
            if (data, mx) not in direct:
                direct[data, mx] = NonceSearcher(
                    data, device=dev, grid=1001).search(0, mx + 1)
            want = direct[data, mx]
            if hash_op(data, el["nonce"]) != el["hash"] \
                    or not 0 <= el["nonce"] <= mx + 1:
                fail(f"elephant: claim check failed: {el}")
            if (el["hash"], el["nonce"]) != want:
                fail(f"elephant {data!r}: {el['hash'], el['nonce']} != "
                     f"direct {want}")
            el["direct_grid1001"] = list(want)
    if runs[0]["launches"]["K5"] <= 0:
        fail(f"the mice path launched no K5: {runs[0]['launches']}")
    for run in runs:
        shed = {t for _, t, _ in run["shed_lines"]}
        if (shed or run["tenants_disconnected"]) and not run["admit"] \
                or len(shed) != run["tenants_disconnected"]:
            fail(f"{run['tag']}: {run['tenants_disconnected']} tenants "
                 f"disconnected, sheds {run['shed_lines']}")


def miner_metrics(log_path: str) -> dict:
    """One miner's final snapshot held to its own ``counts()``: chunks
    served, coalesced dispatches and their chunks, and the model's search
    launches since the launch counts restarted equal to the search
    launches counted (K1-K4, and K5's less one reduce a batched launch).
    Returns its scanned nonces, launches and nonces/s."""
    name = os.path.basename(log_path)
    snap = final_snapshot(log_path, name)
    c = snap["counters"]
    counts = read_counts(log_path)
    mine = (c["miner.chunks_served"], c["miner.coalesced_dispatches"],
            c["miner.chunks_coalesced"])
    want = (counts.get("chunks", 0), counts.get("coalesced_dispatches", 0),
            counts.get("coalesced_chunks", 0))
    if mine != want:
        fail(f"metrics: {name} chunks served, coalesced dispatches and "
             f"chunks {mine} != its counts {want}")
    base = restart_counts(log_path)
    k = launches_of(counts)
    batched = c["model.coalesced_launches"] \
        - base.get("model.coalesced_launches", 0)
    search = sum(k[x] for x in ("K1", "K2", "K3", "K4", "K5")) - batched
    model = c["model.device_launches"] - base.get("model.device_launches", 0)
    if model != search:
        fail(f"metrics: {name} model.device_launches +{model} != its "
             f"search launches {search} ({k}, {batched} batched)")
    return {"nonces_scanned": c["miner.nonces_scanned"],
            "chunks_served": c["miner.chunks_served"],
            "device_launches": model,
            "nonces_per_s": snap["ewmas"]["miner.nonces_per_s"]["value"]}


def assigned_nonces(dicts: list) -> int:
    """The nonces of every chunk a server's traces show it assigned
    (``Upper`` read inclusive)."""
    if any(d.get("events_dropped") for d in dicts):
        fail("metrics: a trace dropped events")
    return sum(e["upper"] - e["lower"] + 1 for d in dicts
               for e in d["events"] if e["event"] == "assign")


def rate_ratio(pool, miners: list):
    """``sched.pool_rate_nps`` over the mean ``miner.nonces_per_s``,
    held within ``RATE_FACTOR`` when both exist; None without a pool rate
    (no throughput window closed)."""
    rates = [m["nonces_per_s"] for m in miners if m["nonces_per_s"]]
    if pool is None or not rates:
        return None
    ratio = pool / (sum(rates) / len(rates))
    if not 1 / RATE_FACTOR <= ratio <= RATE_FACTOR:
        fail(f"metrics: sched.pool_rate_nps {pool} against miner.nonces_"
             f"per_s {rates}: ratio {ratio} outside {RATE_FACTOR}x")
    return ratio


def argmin_metrics(outdir: str, server_log: str, miner_logs: list) -> dict:
    """The arg-min path's metrics: the nonces the miners scanned
    (``miner.nonces_scanned``) equal those of the chunks the scheduler
    assigned, each miner held to its counts (:func:`miner_metrics`),
    every ``sched.miner_trust`` at 1.0 (an honest pool's miners have no
    such series: the gauge is set where a score moves, the JAX rule, so
    an absent one reads 1.0), and the pool's rate beside the miner's."""
    miners = [miner_metrics(log) for log in miner_logs]
    cut = assigned_nonces(exported_traces(outdir, "server")[0])
    scanned = sum(m["nonces_scanned"] for m in miners)
    if scanned != cut:
        fail(f"metrics: the arg-min miners scanned {scanned} nonces, the "
             f"scheduler cut {cut}")
    g = final_snapshot(server_log, "the arg-min server")["gauges"]
    trust = {k: v for k, v in g.items() if k.startswith("sched.miner_trust")}
    if any(v != 1.0 for v in trust.values()):
        fail(f"metrics: an honest miner's trust moved: {trust}")
    pool = g.get("sched.pool_rate_nps")
    return {"nonces_cut": cut, "nonces_scanned": scanned,
            "chunks_served": sum(m["chunks_served"] for m in miners),
            "device_launches": sum(m["device_launches"] for m in miners),
            "trust_series": trust, "pool_rate_nps": pool,
            "miner_nonces_per_s": [m["nonces_per_s"] for m in miners],
            "rate_ratio": rate_ratio(pool, miners)}


def mice_metrics(outdir: str, run: dict) -> dict:
    """A mice run's metrics: each miner held to its counts (coalesced
    dispatches and chunks among them); ``sched.stripe_chunks_per_share``
    with a sample per miner share of each wholesale dispatch in the
    traces; each tenant's ``sched.qos_granted_chunks`` in every snapshot
    line no more than the chunks granted it (the assignments of kind
    ``initial`` or ``qos`` in its traces), read while it lives: the series
    retires with its tenant (a dropped client, the idle GC), so the line
    that shows a tenant's last grant may not exist, and the share of the
    grants seen is reported; and the pool's rate beside the miners'."""
    miners = [miner_metrics(log) for log in run["miner_logs"]]
    dicts, _ = exported_traces(outdir, f"{run['tag']}_server")
    grants: dict = {}
    shares = 0
    for d in dicts:
        for e in d["events"]:
            if e["event"] == "assign" and e.get("kind") in ("initial", "qos"):
                t = d["meta"]["client"]
                grants[t] = grants.get(t, 0) + 1
            elif e["event"] == "dispatch" and e.get("mode") != "chunked":
                shares += len(e["miners"])
    snaps = metric_snapshots(run["server_log"])
    if not snaps or not snaps[-1]["final"]:
        fail(f"metrics: {run['tag']}'s server logged no final snapshot")
    plans = snaps[-1]["snapshot"]["histograms"][
        "sched.stripe_chunks_per_share"]["count"]
    if plans != shares:
        fail(f"metrics: {run['tag']} stripe_chunks_per_share has {plans} "
             f"samples, its wholesale dispatches {shares} shares")
    pref = "sched.qos_granted_chunks{tenant="
    seen: dict = {}
    for s in snaps:
        for key, v in s["snapshot"]["counters"].items():
            if key.startswith(pref):
                t = int(key[len(pref):-1])
                if v > grants.get(t, 0):
                    fail(f"metrics: {run['tag']} {key} {v} > the "
                         f"{grants.get(t, 0)} chunks granted it")
                seen[t] = max(seen.get(t, 0), v)
    if not seen:
        fail(f"metrics: no snapshot of {run['tag']} held a tenant's "
             "granted chunks")
    pool = snaps[-1]["snapshot"]["gauges"].get("sched.pool_rate_nps")
    if pool is None:
        fail(f"metrics: {run['tag']} has no sched.pool_rate_nps after its "
             "warm-up")
    return {"coalesced_dispatches": run["coalesced_dispatches"],
            "chunks_coalesced": run["coalesced_chunks"],
            "stripe_samples": plans, "granted": sum(grants.values()),
            "granted_seen": sum(seen.values()),
            "tenants_seen": len(seen), "snapshot_lines": len(snaps),
            "pool_rate_nps": pool,
            "miner_nonces_per_s": [m["nonces_per_s"] for m in miners],
            "rate_ratio": rate_ratio(pool, miners)}


def lease_metrics(lease: dict, verify: dict) -> dict:
    """The lease path's ``sched.pool_quarantined``: at least 1 while the
    wedged miner was quarantined, 0 in the last line once it answered;
    the verification path's ``sched.miner_trust`` below 1 at some line
    for every miner the server convicted (its FAILED lines)."""
    snaps = metric_snapshots(lease["server_log"])
    quarantined = [s["snapshot"]["gauges"].get("sched.pool_quarantined", 0)
                   for s in snaps]
    if not quarantined or max(quarantined) < 1 or quarantined[-1] != 0:
        fail(f"metrics: the lease path's pool_quarantined over "
             f"{len(snaps)} lines: max {max(quarantined, default=None)}, "
             f"last {quarantined[-1] if quarantined else None}")
    lowest: dict = {}
    for s in metric_snapshots(verify["server_log"]):
        for key, v in s["snapshot"]["gauges"].items():
            if key.startswith("sched.miner_trust{miner="):
                m = int(key[len("sched.miner_trust{miner="):-1])
                lowest[m] = min(lowest.get(m, 1.0), v)
    convicted = {m for m, _ in verify["trust_after_failures"]}
    if not convicted or any(lowest.get(m, 1.0) >= 1.0 for m in convicted):
        fail(f"metrics: convicted miners {sorted(convicted)}, their lowest "
             f"sched.miner_trust {lowest}")
    return {"pool_quarantined_max": max(quarantined),
            "pool_quarantined_last": quarantined[-1],
            "lease_lines": len(snaps),
            "trust_lowest": {str(m): v for m, v in sorted(lowest.items())}}


def procs_metrics(doc: dict) -> dict:
    """The procs path's console after the kill: every live replica's row
    holds a number in ``lease_min_s`` and ``nps``, and no ``trust_min``
    below 1.0 (an honest pool publishes none: the JAX rule)."""
    rows = {p["proc"]: p["detail"] for p in doc["procs"]
            if p["role"] == "replica" and p["status"] == "fresh"}
    for proc, d in rows.items():
        if not all(isinstance(d.get(k), (int, float))
                   for k in ("lease_min_s", "nps")) \
                or d.get("trust_min", 1.0) != 1.0:
            fail(f"metrics: dbmtop's {proc} row {d}")
    if not rows:
        fail("metrics: dbmtop shows no live replica after the kill")
    return {proc: {k: d.get(k) for k in ("trust_min", "lease_min_s", "nps")}
            for proc, d in rows.items()}


def phase_e2e(outdir: str) -> dict:
    """The main paths, each on a cluster of its own so that every launch
    count starts at 0 just before the path. The arg-min path: the port's
    server and one miner on ``cuda``, the requests of
    ``ARGMIN_REQUESTS``. The difficulty path: a new server and two
    miners, then the requests of ``UNTIL_REQUESTS``, R4 through
    ``submit_until`` and R5 through the client CLI."""
    import asyncio

    import torch
    from distributed_bitcoinminer_tpu_torch.apps.client import (
        submit, submit_until)
    from distributed_bitcoinminer_tpu_torch.bitcoin.hash import hash_op
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
    dev = torch.device("cuda", 0)
    # Each path's seconds, its clusters' start and stop included.
    path_s, marks = {}, [time.monotonic()]

    def lap(name: str) -> None:
        marks.append(time.monotonic())
        path_s[name] = round(marks[-1] - marks[-2], 3)
    results = []
    with Cluster(outdir) as c:
        argmin_server = c.start("server", "server", [str(c.port)],
                                "Server listening on port")
        miners = start_miners(c, ["miner"], [None])
        for name, data, max_nonce in ARGMIN_REQUESTS:
            results.append(timed(name, data, max_nonce, lambda: asyncio.run(
                asyncio.wait_for(submit(c.hostport, data, max_nonce), 300))))
        argmin_launches = path_launches(miners)
        argmin_miners = miners
    lap("arg-min")
    with Cluster(outdir) as c:
        server_log = c.start("until_server", "server", [str(c.port)],
                             "Server listening on port")
        miners = start_miners(c, ["until_miner", "until_miner2"],
                              [None, None])
        (r4_name, r4_data, r4_max, r4_target), (r5_name, r5_data, r5_max,
                                                 r5_target) = UNTIL_REQUESTS
        results.append(timed(r4_name, r4_data, r4_max, lambda: asyncio.run(
            asyncio.wait_for(submit_until(c.hostport, r4_data, r4_max,
                                          r4_target), 300))))
        results.append(timed(r5_name, r5_data, r5_max, lambda: cli_submit(
            c, r5_data, r5_max, r5_target)))
        until_launches = path_launches(miners)
        with open(server_log, errors="replace") as f:
            server_text = f.read()
    lap("difficulty")
    # The mice path in turns: the adapt plane on (the default), then off.
    # The cold turn with the admission controller was cut to pay for the
    # analysis phase (the warm pool runs the admission controller on and
    # off).
    mice_adapt = [run_mice(outdir, True, adapt=True, server_env=CAPTURE_ENV,
                           tag="mice_adapt_capture"),
                  run_mice(outdir, False, adapt=True)]
    mice_runs = [run_mice(outdir, True, adapt=False),
                 run_mice(outdir, False, adapt=False)]
    # The warm pool, the admission controller on, then off (the adapt
    # plane on). One turn each: its second pair repeated the first.
    mice_warm = [run_mice(outdir, True, adapt=True, admit=admit, warm=True,
                          tag=f"mice_warm{'_admit' if admit else ''}_1")
                 for admit in (True, False)]
    lap("mice")
    peeled = run_peeled(outdir)
    lap("peeled")
    mesh = run_mesh(outdir)
    lap("mesh")
    pod = run_pod(outdir)
    lap("pod")
    drill = run_pod_drill(outdir)
    lap("pod_drill")
    replicas = run_replicas(outdir)
    lap("replicas")
    procs_run = run_procs(outdir)
    lap("procs")
    gateway = run_gateway(outdir)
    lap("gateway")
    gather = pod_gather_ms([POD_RANK_DEVICES] * 2)
    lap("pod_gather")
    lease = run_lease(outdir)
    lap("lease")
    verify = run_verify(outdir)
    lap("verify")
    sched_adapt = run_sched(outdir, adapt=True)
    lap("sched_adapt")
    sched = run_sched(outdir, adapt=False)
    lap("sched")
    for path, counts, kernels in (("arg-min", argmin_launches, ("K1", "K6")),
                                  ("difficulty", until_launches,
                                   ("K2", "K6"))):
        for kern in kernels:
            if counts.get(kern, 0) <= 0:
                fail(f"the {path} path launched no {kern}: {counts}")
        if counts["K3"] or counts["K4"]:
            fail(f"the {path} path launched a peeled body: {counts}")
    # Checks, after the clusters are down (the card is free again).
    by_name = {r["request"]: r for r in results}
    plain = {}
    for r in results:
        hi_nonce = r["max_nonce"] + 1
        if hash_op(r["data"], r["nonce"]) != r["hash"] \
                or not 0 <= r["nonce"] <= hi_nonce:
            fail(f"{r['request']}: claim check failed: {r}")
        if r["request"] in ("R3", "R4", "R5"):
            continue
        key = (r["data"], hi_nonce)
        if key not in plain:
            plain[key] = plain_search(
                NonceSearcher(r["data"], device=dev), 0, hi_nonce)
        r["plain"] = list(plain[key])
        if (r["hash"], r["nonce"]) != plain[key]:
            fail(f"{r['request']}: {r['hash'], r['nonce']} != plain "
                 f"{plain[key]}")
    r3 = by_name["R3"]
    want = NonceSearcher(r3["data"], device=dev, grid=37).search(
        0, r3["max_nonce"] + 1)
    r3["direct_grid37"] = list(want)
    if (r3["hash"], r3["nonce"]) != want:
        fail(f"R3: {r3['hash'], r3['nonce']} != direct {want}")
    r4 = by_name["R4"]
    if not r4["hash"] < R4_TARGET:
        fail(f"R4: hash {r4['hash']} is not below the target {R4_TARGET}")
    # Two miners: chunk 0 is [0, 2^31] (one miner's), chunk 1
    # [2^31, 2^32] (each miner scans its upper bound too); a hit in chunk
    # 0 releases before chunk 1 answers.
    ranges = {"request": (0, r4["max_nonce"] + 1),
              "chunk1": R4_CHUNKS[1]}
    r4["plain"], r4["direct"] = {}, {}
    for rname, (lower, upper) in ranges.items():
        want = plain_search_until(NonceSearcher(r4["data"], device=dev),
                                  lower, upper, R4_TARGET)
        r4["plain"][rname] = list(want)
        for grid in (None, 37):
            got = NonceSearcher(r4["data"], device=dev,
                                grid=grid).search_until(lower, upper,
                                                        R4_TARGET)
            r4["direct"][f"{rname}_grid{grid or 'default'}"] = list(got)
            if got != want:
                fail(f"R4 {rname} [{lower}, {upper}] at grid {grid}: "
                     f"{got} != plain {want}")
        if not want[2]:
            fail(f"R4 {rname}: no nonce below the target in [{lower}, "
                 f"{upper}]")
    if [r4["hash"], r4["nonce"], True] != r4["plain"]["request"]:
        fail(f"R4: {r4['hash'], r4['nonce']} != plain "
             f"{r4['plain']['request']}")
    r4["chunk"] = 0 if r4["nonce"] <= R4_CHUNKS[0][1] else 1
    r4["prefix_release_logged"] = "(prefix release)" in server_text
    if r4["chunk"] == 0 and not r4["prefix_release_logged"]:
        fail("R4 hit in chunk 0 but the server logged no prefix release")
    r1, r5 = by_name["R1"], by_name["R5"]
    if (r5["hash"], r5["nonce"]) != (r1["hash"], r1["nonce"]):
        fail(f"R5 {r5['hash'], r5['nonce']} != R1 "
             f"{r1['hash'], r1['nonce']}")
    check_mice(mice_runs + mice_adapt + mice_warm, dev)
    for run in mice_adapt + mice_warm:
        check_adapt_bounds(run["tag"], run["adapt"])
    for run in mice_adapt + mice_runs + mice_warm:
        run["plans"] = check_chunk_plans(run)
    for run in mice_warm:
        if not run["adapt"].get("chunk_adjustments") \
                or not run["plans"]["multi_chunk_after_move"]:
            fail(f"{run['tag']}: no elephant planned from a moved chunk "
                 f"seconds: {run['adapt']}, {run['plans']}")
    for run in mice_adapt + mice_runs + mice_warm:
        print(f"{run['tag']}: {run['mice_answered']} mice answered, "
              f"{run['tenants_disconnected']} tenants shed; p50 "
              f"{run['mice_p50_s']} s, p99 {run['mice_p99_s']} s, "
              f"elephant {run['elephant']['seconds']:.3f} s; adapt "
              f"{json.dumps(run['adapt']) if run['adapt'] else 'off'}; "
              f"chunk plans {json.dumps(run['plans'])}", flush=True)
    check_peeled(peeled, by_name, dev)
    check_mesh_paths(mesh, by_name)
    check_pod(pod, by_name)
    check_pod_drill(drill, mice_runs[0]["elephant"])
    check_replicas(replicas, by_name, mice_runs[0])
    procs_summary = check_procs(procs_run, by_name, dev)
    metrics = {"argmin": argmin_metrics(outdir, argmin_server,
                                        argmin_miners),
               "mice": mice_metrics(outdir, mice_runs[0]),
               "procs": procs_metrics(procs_run["dbmtop_after"])}
    check_gateway(gateway, by_name)
    ring_s = {f"{r['request']}@replica{r['replica']}": round(r["seconds"], 4)
              for r in procs_run["requests"]}
    gw_s = {r["request"]: round(r["seconds"], 4)
            for r in gateway["requests"]}
    print(f"procs: ring seconds {json.dumps(ring_s)} against one server's "
          f"R1 {by_name['R1']['seconds']:.4f}, R3 "
          f"{by_name['R3']['seconds']:.4f}, R4 {by_name['R4']['seconds']:.4f};"
          f" elephant granted after {procs_run['granted_s']:.3f} s, kill -9 "
          f"of replica {procs_run['owner']} -> fence "
          f"{procs_run['fence_s']:.3f} s -> reply {procs_run['reply_s']:.3f}"
          f" s; dbmtop max age {procs_summary['max_age_before_s']} s at a "
          f"{procs_summary['beat_s']} s beat; host-tier R1 "
          f"{procs_run['host_r1']['seconds']:.4f} s; gateway seconds "
          f"{json.dumps(gw_s)} (R3 {by_name['R3']['seconds']:.4f} s on one "
          f"miner), JOIN hint {gateway['gateway_join']['hint']:.6g} = "
          f"{' + '.join(f'{h:.6g}' for h in gateway['child_hints'])}, "
          f"{len(gateway['parent_refreshes'])} refreshes", flush=True)
    procs_run["dbmtop_before"] = [
        (p["proc"], p["status"], p["age_s"])
        for p in procs_run["dbmtop_before"]["procs"]]
    procs_run["dbmtop_after"] = [
        (p["proc"], p["status"], p["age_s"])
        for p in procs_run["dbmtop_after"]["procs"]]
    capture = check_capture(mice_adapt[0], mice_runs[0])
    mesh_r3 = next(r for r in mesh["default"]["requests"]
                   if r["request"] == "R3")
    pod_r3 = next(r for r in pod["requests"] if r["request"] == "R3")
    print(f"pod: rows over {pod['backend']}, {gather['ms_per_gather'][0]:.4f} "
          f"ms a row gather (synchronised); R3 {pod_r3['seconds']:.4f} s on "
          f"the pod of 2 ranks x 2 shards of card 0, "
          f"{mesh_r3['seconds']:.4f} s on the one-process mesh "
          f"{mesh['devices']}; drill: owner exit {drill['owner_rc']} after "
          f"{drill['owner_exit_s']:.3f} s", flush=True)
    check_lease(lease, by_name)
    check_verify(verify, by_name)
    metrics["lease_verify"] = lease_metrics(lease, verify)
    emit("metrics", **metrics)
    check_sched(sched, by_name, mice_runs[0], dev)
    check_sched(sched_adapt, by_name, mice_runs[0], dev, counted=False,
                answers=sched)
    for run in (sched_adapt, sched):
        print(f"{run['tag']}: adapt "
              f"{json.dumps(run['adapt']) if any(run['adapt'].values()) else 'off'}",
              flush=True)
    traced = check_trace(outdir, results, mice_runs[0], lease)
    st = sched["striping"]
    print(f"sched: rate hint {st['rate_hint']:.6g} nonces/s (the probe), "
          f"R3 {st['requests'][0]['nonces_per_s']:.6g} nonces/s striped "
          f"from it, {st['requests'][2]['nonces_per_s']:.6g} on the warm "
          f"pool", flush=True)
    # Leases run on every path at their defaults (30 s on a cold pool, 2 s
    # at least on a warm one); a blown one is reported here, not hidden.
    blown = {os.path.basename(os.path.dirname(log))[4:]: count_lines(
        log, {"n": LEASE_LINES["blown"]})["n"]
        for log in sorted(glob.glob(os.path.join(outdir, "e2e_*server",
                                                 "log.txt")))}
    lap("checks")
    info = {"path_s": path_s,
            "requests": results, "mice": mice_runs, "mice_adapt": mice_adapt,
            "mice_warm": mice_warm,
            "peeled": peeled, "mesh": mesh, "pod": pod, "pod_drill": drill,
            "pod_gather": gather, "replicas": replicas, "capture": capture,
            "procs": procs_run, "gateway": gateway,
            "lease": lease,
            "verify": verify, "sched": sched, "sched_adapt": sched_adapt,
            "trace": traced, "blown_leases_by_server": blown,
            "launches": {"arg-min": argmin_launches,
                         "difficulty": until_launches,
                         "mice": mice_runs[0]["launches"],
                         "mice_per_chunk": mice_runs[1]["launches"],
                         "mice_adapt": mice_adapt[0]["launches"],
                         "mice_per_chunk_adapt": mice_adapt[1]["launches"],
                         **{run["tag"]: run["launches"]
                            for run in mice_warm},
                         **{f"peeled_{leg}": run["launches"]
                            for leg, run in peeled.items()},
                         **{f"mesh_{leg}": run["launches"]
                            for leg, run in mesh.items()
                            if isinstance(run, dict)},
                         "pod": {k: sum(r[k] for r in pod["launches"])
                                 for k in KERNELS},
                         "replicas": replicas["launches"],
                         "procs": procs_summary["launches"],
                         "gateway": gateway["launches"],
                         "lease": sum_launches(lease["launches"]),
                         "verify": sum_launches(verify["launches"]),
                         "sched": sched["launches"],
                         "sched_adapt": sched_adapt["launches"]}}
    emit("e2e", **info)
    return info


#: The span keys every chunk's span carries (``dispatch_s`` too unless it
#: is a blocking chunk, ``serial``; ``gap_s`` from each miner's second
#: chunk on).
SPAN_ALWAYS = ("queue_s", "wait_s", "force_s")


def trace_spans(dicts: list) -> list:
    """``(trace dict, miner_span event)`` of every folded span."""
    return [(d, ev) for d in dicts for ev in d["events"]
            if ev["event"] == "miner_span"]


def check_trace(outdir: str, results: list, mice: dict, lease: dict) -> dict:
    """The tracing plane's checks, from the servers' exported traces
    (read once they have stopped). The arg-min path: every Result folded
    a span into its request's trace (as many ``miner_span`` as
    ``result`` events), each span holds the phases (``SPAN_ALWAYS``,
    ``dispatch_s`` on a two-phase chunk, ``gap_s`` on all but each
    miner's first), each >= 0, its ``force_s`` no more than the request's
    wall time at the client, and the Perfetto document has one
    ``request`` slice a request. The mice path (coalescing on, adapt
    off): the spans of a coalesced window share its launch id, as many as
    its ``lanes``. The lease path: a flight-recorder dump is one JSON line
    holding the blown leases. The difficulty path: R4's and R5's seconds
    split into each miner's span phases and the scheduler's remainder
    (the client's wall time less the longest chunk's phases)."""
    from distributed_bitcoinminer_tpu_torch.utils.trace import SPAN_PHASES
    argmin = [r for r in results if r["request"] in
              {n for n, _, _ in ARGMIN_REQUESTS}]
    dicts, doc = exported_traces(outdir, "server")
    jobs = sorted((d for d in dicts if isinstance(d["key"], int)),
                  key=lambda d: d["key"])
    if len(jobs) != len(argmin):
        fail(f"trace: {len(jobs)} traces on the arg-min path, "
             f"{len(argmin)} requests")
    first_seen, spans = set(), 0
    for d, r in zip(jobs, argmin):
        names = [ev["event"] for ev in d["events"]]
        if d["meta"]["upper"] != r["max_nonce"] or names[-1] != "reply":
            fail(f"trace of {r['request']}: {d['meta']}, last {names[-1]}")
        if names.count("miner_span") != names.count("result") \
                or not names.count("result"):
            fail(f"trace of {r['request']}: {names.count('result')} "
                 f"results, {names.count('miner_span')} spans")
        for _, ev in trace_spans([d]):
            spans += 1
            need = set(SPAN_ALWAYS)
            if not ev.get("serial"):
                need.add("dispatch_s")
            if ev["miner"] in first_seen:
                need.add("gap_s")
            first_seen.add(ev["miner"])
            if not need <= set(ev) or any(ev[k] < 0 for k in SPAN_PHASES
                                          if k in ev):
                fail(f"trace of {r['request']}: span {ev}")
            if ev["force_s"] > r["seconds"]:
                fail(f"trace of {r['request']}: force {ev['force_s']} s > "
                     f"the request's {r['seconds']} s")
    slices = [e for e in doc["traceEvents"] if e["ph"] == "X"
              and e["name"].startswith("request ")]
    if len(slices) != len(argmin):
        fail(f"trace: {len(slices)} request slices in the export, "
             f"{len(argmin)} requests")
    mdicts, _ = exported_traces(outdir, f"{mice['tag']}_server")
    windows: dict = {}
    for _, ev in trace_spans(mdicts):
        if "launch" in ev:
            windows.setdefault((ev["miner"], ev["launch"]), []).append(
                ev["lanes"])
    bad = {k: v for k, v in windows.items()
           if len(set(v)) != 1 or v[0] != len(v)}
    if not windows or bad:
        fail(f"trace: coalesced windows {len(windows)}, mismatched {bad}")
    dumps = []
    with open(os.path.join(server_dir(outdir, "lease_server"),
                           "log.txt"), errors="replace") as f:
        for line in f:
            if "flight recorder dump (" in line:
                dumps.append(json.loads(line.split("): ", 1)[1]))
    if not dumps or not any(ev["event"] == "lease_blown"
                            for d in dumps for ev in d["events"]):
        fail(f"trace: {len(dumps)} flight dumps on the lease path")
    udicts, _ = exported_traces(outdir, "until_server")
    split = {}
    for name, data, max_nonce, target in UNTIL_REQUESTS:
        (d,) = [d for d in udicts if d["meta"]["target"] == target]
        r = next(x for x in results if x["request"] == name)
        ev = {e["event"]: e for e in d["events"]}
        chunks = [{k: e.get(k) for k in ("miner", "idx", *SPAN_PHASES)}
                  for _, e in trace_spans([d])]
        longest = max(sum(c[k] or 0.0 for k in SPAN_PHASES if k != "gap_s")
                      for c in chunks)
        split[name] = {
            "client_s": r["seconds"],
            "queued_s": ev["dispatch"]["t"] - ev["enqueue"]["t"],
            "dispatch_to_reply_s": ev["reply"]["elapsed_s"],
            "chunks": chunks, "longest_chunk_s": longest,
            "scheduler_remainder_s": r["seconds"] - longest}
    out = {"argmin_spans": spans, "argmin_request_slices": len(slices),
           "coalesced_windows": len(windows),
           "lease_flight_dumps": len(dumps), "split": split}
    print(f"trace: {spans} spans on the arg-min path, one request slice "
          f"each of {len(slices)}; {len(windows)} coalesced windows' "
          f"spans share their launch; {len(dumps)} flight dumps on the "
          f"lease path; " + "; ".join(
              f"{n} {v['client_s']:.4f} s = chunk {v['longest_chunk_s']:.4f}"
              f" + remainder {v['scheduler_remainder_s']:.4f}"
              for n, v in split.items()), flush=True)
    return out


#: The peeled paths' miners: K4 (the default hoist), then K3.
PEEL_ENV = {"DBMT_PEEL": "1"}
PEEL_K3_ENV = {"DBMT_PEEL": "1", "DBMT_HOIST": "0"}


def serve_requests(outdir: str, tag: str, miner_envs: list,
                   argmin: tuple, until: tuple) -> dict:
    """A new server and one miner per entry of ``miner_envs``; the
    arg-min requests ``argmin`` (name, data, max_nonce) through
    ``submit``, then the difficulty requests ``until`` (name, data,
    max_nonce, target) through ``submit_until``. Returns the timed
    results, the miners' launches, and whether the server logged a
    prefix release."""
    import asyncio

    from distributed_bitcoinminer_tpu_torch.apps.client import (
        submit, submit_until)
    results = []
    with Cluster(outdir) as c:
        server_log = c.start(f"{tag}_server", "server", [str(c.port)],
                             "Server listening on port")
        miners = start_miners(
            c, [f"{tag}_miner{j or ''}" for j in range(len(miner_envs))],
            miner_envs)
        for name, data, max_nonce in argmin:
            results.append(timed(name, data, max_nonce, lambda: asyncio.run(
                asyncio.wait_for(submit(c.hostport, data, max_nonce), 300))))
        for name, data, max_nonce, target in until:
            results.append(timed(name, data, max_nonce, lambda: asyncio.run(
                asyncio.wait_for(submit_until(c.hostport, data, max_nonce,
                                              target), 300))))
        launches = path_launches(miners)
        chunks = served_chunks(miners)
        with open(server_log, errors="replace") as f:
            release = "(prefix release)" in f.read()
    return {"requests": results, "launches": launches, "chunks": chunks,
            "prefix_release_logged": release}


def run_peeled(outdir: str) -> dict:
    """The peeled paths, each on a new cluster: two miners with
    ``DBMT_PEEL=1`` (K4) serve R1, R2, R3 and R4; then the mice path
    with coalescing on, its miners with ``DBMT_PEEL=1``; then one miner
    with ``DBMT_PEEL=1 DBMT_HOIST=0`` (K3) serves R1, R2 and R4."""
    by_name = {r[0]: r for r in ARGMIN_REQUESTS}
    r4 = UNTIL_REQUESTS[0]
    k4 = serve_requests(outdir, "peel", [PEEL_ENV, PEEL_ENV],
                        tuple(by_name[n] for n in ("R1", "R2", "R3")), (r4,))
    mice = run_mice(outdir, True, PEEL_ENV, tag="mice_peel")
    k3 = serve_requests(outdir, "peel_k3", [PEEL_K3_ENV],
                        tuple(by_name[n] for n in ("R1", "R2")), (r4,))
    return {"k4": k4, "k4_mice": mice, "k3": k3}


def check_peeled(peeled: dict, default: dict, dev) -> None:
    """Every answer of the peeled paths equal to the same request's on
    the default path (each held there to the plain scans, the claim check
    or a direct search), R4 held to the target and to the prefix release
    as there, every mouse to the plain scan; the launch counts: K4 (then
    K3) and the chain's folds, K5's reduce on the mice path, and no K1,
    K2 or other peeled search."""
    from distributed_bitcoinminer_tpu_torch.bitcoin.hash import hash_op
    for leg, kern, other in (("k4", "K4", "K3"), ("k3", "K3", "K4")):
        run = peeled[leg]
        for r in run["requests"]:
            want = default[r["request"]]
            if hash_op(r["data"], r["nonce"]) != r["hash"] or \
                    (r["hash"], r["nonce"]) != (want["hash"],
                                                want["nonce"]):
                fail(f"peeled path {leg} {r['request']}: "
                     f"{r['hash'], r['nonce']} != the default path's "
                     f"{want['hash'], want['nonce']}")
            if r["request"] == "R4" and leg == "k4":   # two miners
                r["chunk"] = 0 if r["nonce"] <= R4_CHUNKS[0][1] else 1
                if r["chunk"] == 0 and not run["prefix_release_logged"]:
                    fail(f"peeled path {leg}: R4 hit in chunk 0 but the "
                         "server logged no prefix release")
        counts = run["launches"]
        if counts[kern] <= 0 or counts["K6"] <= 0 or counts["K1"] \
                or counts["K2"] or counts[other]:
            fail(f"the peeled path {leg} launched {counts}")
    mice = peeled["k4_mice"]
    check_mice([mice], dev)
    counts = mice["launches"]
    if counts["K4"] <= 0 or counts["K1"] or counts["K2"] or counts["K3"]:
        fail(f"the peeled mice path launched {counts}")


def mesh_devices() -> str:
    """The mesh paths' ``DBMT_MESH_DEVICES``: every card of a box with
    several, else card 0 four times."""
    import torch
    count = torch.cuda.device_count()
    return ",".join(f"cuda:{i}" for i in range(count)) if count > 1 \
        else ",".join(["cuda:0"] * 4)


def run_mesh(outdir: str) -> dict:
    """The mesh paths, each on a new server: two miners over the mesh of
    :func:`mesh_devices` serve R1, R2, R3, the mouse and R4 (two, so that
    R4 splits into two chunks and its hit in chunk 0 is released before
    chunk 1 answers); then one peeled mesh miner (``DBMT_PEEL=1``, K4)
    serves R1 and R4."""
    env = {"DBMT_MESH_DEVICES": mesh_devices()}
    by_name = {r[0]: r for r in ARGMIN_REQUESTS}
    r4 = UNTIL_REQUESTS[0]
    default = serve_requests(
        outdir, "mesh", [env, env],
        tuple(by_name[n] for n in ("R1", "R2", "R3", "mouse")), (r4,))
    peeled = serve_requests(outdir, "mesh_peel", [{**env, **PEEL_ENV}],
                            (by_name["R1"],), (r4,))
    return {"devices": env["DBMT_MESH_DEVICES"], "default": default,
            "peel": peeled}


def check_mesh_paths(mesh: dict, default: dict) -> None:
    """Every answer of the mesh paths equal to the same request's on the
    default path (each held there to the plain scans, the claim check or
    a direct search), R4 held to the prefix release with two miners; the
    launches: one mesh fold (K6mesh) per block served and distinct
    device of the mesh; per block one to n shard searches, each with its
    reduce (on the default leg K1 or K2 both; on the peeled leg the
    search K4 and the reduce K1 or K2); no single-device K6 fold, no
    other body."""
    from distributed_bitcoinminer_tpu_torch.bitcoin.hash import hash_op
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
    devices = mesh["devices"].split(",")
    holders = len(set(devices))
    for leg in ("default", "peel"):
        run = mesh[leg]
        for r in run["requests"]:
            want = default[r["request"]]
            if hash_op(r["data"], r["nonce"]) != r["hash"] or \
                    (r["hash"], r["nonce"]) != (want["hash"],
                                                want["nonce"]):
                fail(f"mesh path {leg} {r['request']}: "
                     f"{r['hash'], r['nonce']} != the default path's "
                     f"{want['hash'], want['nonce']}")
            if r["request"] == "R4" and leg == "default":   # two miners
                r["chunk"] = 0 if r["nonce"] <= R4_CHUNKS[0][1] else 1
                if r["chunk"] == 0 and not run["prefix_release_logged"]:
                    fail("mesh path: R4 hit in chunk 0 but the server "
                         "logged no prefix release")
        counts = run["launches"]
        run["blocks"] = blocks = sum(
            len(list(NonceSearcher(data, device="cpu").plan(lower, upper)))
            for data, lower, upper in run["chunks"])
        calls = counts["K1"] + counts["K2"]
        if leg == "default":
            run["shard_searches"] = searches = calls // 2
            ok = calls % 2 == 0 and counts["K1"] > 0 and counts["K2"] > 0 \
                and not counts["K4"]
        else:
            run["shard_searches"] = searches = counts["K4"]
            ok = calls == searches
        if not (ok and blocks and blocks <= searches <= len(devices) * blocks
                and counts["K6mesh"] == blocks * holders
                and not any(counts[k] for k in ("K3", "K5", "K6"))):
            fail(f"the mesh path {leg} launched {counts} over {blocks} "
                 f"blocks on {len(devices)} shards, {holders} devices")


#: A pod of two ranks on card 0, each rank a mesh of two shards of it
#: (``parallel.multihost``): their rows cross through gloo, as NCCL
#: refuses two ranks on one card.
POD_RANK_DEVICES = "cuda:0,cuda:0"


def read_rank_counts(log_path: str) -> dict:
    """A pod rank's last counts line: the owner's ``miner counts``, a
    follower's ``follower counts``."""
    last = {}
    with open(log_path, errors="replace") as f:
        for line in f:
            for marker in ("miner counts ", "follower counts "):
                if marker in line:
                    last = json.loads(line.split(marker, 1)[1])
    return last


def start_pod(c: Cluster, tag: str, devices_of, env: dict | None = None
              ) -> list:
    """The ranks of one pod miner (rank r's local mesh ``devices_of(r)``,
    ``DBMT_MESH_DEVICES``); returns their logs, the owner's first, once
    the owner has joined and every follower's mesh is warm. Each rank's
    launch counts must start at 0."""
    world = len(devices_of)
    pod_env = {"DBMT_COORDINATOR": f"127.0.0.1:{free_tcp_port()}",
               "DBMT_NUM_PROCS": str(world), **(env or {})}
    logs, procs = [], []
    for r in range(world):
        logs.append(c.spawn(f"{tag}_rank{r}", "miner",
                            [c.hostport, "--device", "cuda"],
                            {**pod_env, "DBMT_PROC_ID": str(r),
                             "DBMT_MESH_DEVICES": devices_of[r]}))
        procs.append(c.procs[-1])
    wait_for_line(logs[0], "joined ", procs[0])
    for log, proc in zip(logs[1:], procs[1:]):
        wait_for_line(log, "follower rank ", proc)
    for log in logs:
        if read_rank_counts(log):
            fail(f"{log}: a pod rank's counts were not 0 before its path")
    return logs


def free_tcp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pod_backend(rank_log: str) -> str:
    """The row exchange a pod rank logged (``rows over <backend> (why)``)."""
    with open(rank_log, errors="replace") as f:
        m = re.search(r"rows over (\w+ \([^)]*\))", f.read())
    if m is None:
        fail(f"{rank_log}: no row-exchange line")
    return m.group(1)


def run_pod(outdir: str, tag: str = "pod", devices_of=None,
            argmin_names=("R1", "R2", "R3", "mouse"),
            until=True) -> dict:
    """The pod path on a new server: one pod miner (two ranks on card 0
    by default, each a mesh of two shards of it) serves the arg-min
    requests ``argmin_names`` and R4. Returns the answers, each rank's
    launches and row gathers, the chunks the owner served, the backend
    line, and how many miners the server saw join."""
    import asyncio

    from distributed_bitcoinminer_tpu_torch.apps.client import (
        submit, submit_until)
    devices_of = devices_of or [POD_RANK_DEVICES] * 2
    by_name = {r[0]: r for r in ARGMIN_REQUESTS}
    results = []
    with Cluster(outdir) as c:
        server_log = c.start(f"{tag}_server", "server", [str(c.port)],
                             "Server listening on port")
        logs = start_pod(c, tag, devices_of)
        for name in argmin_names:
            _, data, max_nonce = by_name[name]
            results.append(timed(name, data, max_nonce, lambda: asyncio.run(
                asyncio.wait_for(submit(c.hostport, data, max_nonce), 300))))
        if until:
            name, data, max_nonce, target = UNTIL_REQUESTS[0]
            results.append(timed(name, data, max_nonce, lambda: asyncio.run(
                asyncio.wait_for(submit_until(c.hostport, data, max_nonce,
                                              target), 300))))
        time.sleep(0.5)
        ranks = [read_rank_counts(log) for log in logs]
        chunks = served_chunks(logs[:1])
        backend = pod_backend(logs[0])
        with open(server_log, errors="replace") as f:
            joins = f.read().count(" joined")
    return {"requests": results, "devices_of": devices_of,
            "launches": [launches_of(r) for r in ranks],
            "row_gathers": [r.get("row_gathers") for r in ranks],
            "chunks": chunks, "backend": backend, "joins": joins,
            "rank_logs": logs}


def check_pod(pod: dict, default: dict) -> None:
    """Every answer of the pod path equal to the same request's on the
    default path (each held there to the plain scans, the claim check or
    a direct search); the server saw one miner join; on every rank per
    block served one mesh fold for each of its distinct devices
    (``K6mesh``) and one row gather, one to all of its shards' searches
    (K1 or K2 each with its reduce), and no single-device K6 fold or
    other kernel."""
    from distributed_bitcoinminer_tpu_torch.bitcoin.hash import hash_op
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
    for r in pod["requests"]:
        want = default[r["request"]]
        if hash_op(r["data"], r["nonce"]) != r["hash"] or \
                (r["hash"], r["nonce"]) != (want["hash"], want["nonce"]):
            fail(f"pod path {r['request']}: {r['hash'], r['nonce']} != "
                 f"the default path's {want['hash'], want['nonce']}")
    if pod["joins"] != 1:
        fail(f"the pod path's server saw {pod['joins']} joins, not one")
    pod["blocks"] = blocks = sum(
        len(list(NonceSearcher(data, device="cpu").plan(lower, upper)))
        for data, lower, upper in pod["chunks"])
    if len(pod["chunks"]) != len(pod["requests"]) or not blocks:
        fail(f"the pod's owner served {pod['chunks']}")
    for rank, (counts, gathers, devices) in enumerate(zip(
            pod["launches"], pod["row_gathers"], pod["devices_of"])):
        shards, holders = len(devices.split(",")), len(set(
            devices.split(",")))
        calls = counts["K1"] + counts["K2"]
        searches = calls // 2
        if not (calls % 2 == 0 and searches <= shards * blocks
                and counts["K6mesh"] == blocks * holders
                and gathers == blocks
                and not any(counts[k] for k in ("K3", "K4", "K5", "K6"))):
            fail(f"pod rank {rank} launched {counts} with {gathers} row "
                 f"gathers over {blocks} blocks on {devices}")
    searches = sum((c["K1"] + c["K2"]) // 2 for c in pod["launches"])
    if not blocks <= searches:
        fail(f"the pod's ranks searched {searches} windows over {blocks} "
             "blocks")
    pod["shard_searches"] = searches


#: The drill's bound on a pod job (``DBMT_POD_TIMEOUT_S``), seconds.
POD_DRILL_TIMEOUT_S = 20
#: Seconds a pod rank may take to end after it decided to exit: the bound
#: runs from the job's start, and a process whose NCCL kernel still waits
#: on a dead peer takes about 0.1 s to tear down (run AC, PR 12: 20.047 s
#: from the kill to the owner's end, its exit logged 20.0 s after the
#: job's start).
POD_EXIT_TEARDOWN_S = 2


def run_pod_drill(outdir: str, tag: str = "pod_drill", devices_of=None,
                  job: tuple = ELEPHANT) -> dict:
    """The follower-death drill on a new server: a pod (two ranks on card
    0 by default; rank r's local mesh ``devices_of[r]``) with
    ``DBMT_POD_TIMEOUT_S`` at :data:`POD_DRILL_TIMEOUT_S` takes ``job``
    (data, max nonce); its last follower is killed as its first job
    starts; the owner must exit with code 17 within the bound, without
    having served the job; a plain miner that joins afterwards serves
    the chunk."""
    import asyncio
    import concurrent.futures

    from distributed_bitcoinminer_tpu_torch.apps.client import submit
    devices_of = devices_of or [POD_RANK_DEVICES] * 2
    with Cluster(outdir) as c:
        c.start(f"{tag}_server", "server", [str(c.port)],
                "Server listening on port")
        logs = start_pod(c, tag, devices_of,
                         {"DBMT_POD_TIMEOUT_S": str(POD_DRILL_TIMEOUT_S)})
        owner, follower = c.procs[-len(devices_of)], c.procs[-1]
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            t0 = time.monotonic()
            answer = pool.submit(lambda: asyncio.run(asyncio.wait_for(
                submit(c.hostport, *job), 300)))
            wait_until("the follower's job", lambda: "follower job 1" in
                       open(logs[-1], errors="replace").read(), follower,
                       timeout=120)
            follower.kill()
            follower.wait()
            t_kill = time.monotonic()
            try:
                rc = owner.wait(timeout=POD_DRILL_TIMEOUT_S + 5)
            except subprocess.TimeoutExpired:
                fail(f"{tag}: the pod's owner outlived its bound after the "
                     "follower died")
            exit_s = time.monotonic() - t_kill
            spare = c.start(f"{tag}_spare", "miner",
                            [c.hostport, "--device", "cuda"], "joined ")
            res = answer.result(timeout=300)
            seconds = time.monotonic() - t0
        with open(logs[0], errors="replace") as f:
            owner_text = f.read()
        spare_chunks = served_chunks([spare])
    return {"tag": tag, "devices_of": devices_of, "owner_rc": rc,
            "owner_exit_s": exit_s,
            "peer_error_logged": "a pod collective failed" in owner_text,
            "bound_logged": "outlived its bound" in owner_text,
            "owner_chunks": served_chunks(logs[:1]),
            "elephant": None if res is None else
            {"hash": res[0], "nonce": res[1], "seconds": seconds},
            "spare_chunks": spare_chunks}


def check_pod_drill(drill: dict, want: dict) -> None:
    """The owner out with 17 within the bound (from the job's start, which
    comes before the kill) and its teardown, having logged why (a peer's
    error or the bound), and before it served the job (so the follower
    died mid-job); the plain miner serving the chunk; the answer equal
    to ``want``'s."""
    tag = drill["tag"]
    if drill["owner_rc"] != 17 or drill["owner_exit_s"] > \
            POD_DRILL_TIMEOUT_S + POD_EXIT_TEARDOWN_S or not (
                drill["peer_error_logged"] or drill["bound_logged"]):
        fail(f"{tag}: the owner exited {drill['owner_rc']} after "
             f"{drill['owner_exit_s']:.3f} s (peer error logged: "
             f"{drill['peer_error_logged']}, bound logged: "
             f"{drill['bound_logged']})")
    if drill["owner_chunks"]:
        fail(f"{tag}: the owner served {drill['owner_chunks']} before the "
             "follower died")
    el = drill["elephant"]
    if el is None or (el["hash"], el["nonce"]) != (want["hash"],
                                                   want["nonce"]):
        fail(f"{tag}: the answer {el} != {want}")
    if not drill["spare_chunks"]:
        fail(f"{tag}: the plain miner served no chunk")


#: The pod row-exchange benchmark: gathers of a block's rows (two shards
#: a rank, the until layout's 5 words) timed over this many gathers.
POD_GATHERS = 200


def pod_gather_rank(coordinator: str, world: int, rank: int,
                    devices: str) -> int:
    """``--pod-gather``: one rank of a pod that times ``POD_GATHERS`` row
    gathers of a block (two rows of 5 words) on its first device, after a
    warm-up, each followed by a synchronisation of the card, and prints
    its backend and the ms a gather on one line of JSON."""
    sys.path.insert(0, ROOT)
    import torch
    from distributed_bitcoinminer_tpu_torch.parallel import multihost
    from distributed_bitcoinminer_tpu_torch.utils.config import PodParams
    pod = multihost.initialize_multihost(
        devices.split(","), PodParams(coordinator, world, rank))
    rows = torch.full((pod.n_local, 5), rank, dtype=torch.int32,
                      device=pod.devices[0])
    for _ in range(20):
        out = pod.gather(rows)
    torch.cuda.synchronize(pod.devices[0])
    t0 = time.perf_counter()
    for _ in range(POD_GATHERS):
        out = pod.gather(rows)
        torch.cuda.synchronize(pod.devices[0])
    ms = (time.perf_counter() - t0) * 1e3 / POD_GATHERS
    want = torch.arange(world).repeat_interleave(pod.n_local)
    ok = bool((out[:, 0].cpu() == want.to(torch.int32)).all())
    print(json.dumps({"rank": rank, "backend": pod.backend,
                      "ms_per_gather": ms, "rows": int(out.shape[0]),
                      "ok": ok}), flush=True)
    multihost.shutdown()
    return 0 if ok else 1


def pod_gather_ms(devices_of: list) -> dict:
    """The row exchange's cost a block: one ``--pod-gather`` process a
    rank (rank r's local mesh ``devices_of[r]``), each gather
    synchronised on the card; returns the backend and rank 0's ms."""
    coord = f"127.0.0.1:{free_tcp_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--pod-gather", coord,
         str(len(devices_of)), str(r), devices_of[r]],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(len(devices_of))]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            fail("the pod gather benchmark timed out")
        if p.returncode != 0:
            fail(f"the pod gather benchmark failed: {err[-2000:]}")
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return {"devices_of": devices_of, "backend": outs[0]["backend"],
            "ms_per_gather": [o["ms_per_gather"] for o in outs],
            "rows": outs[0]["rows"]}


#: The capture run: the mice path's default settings (adapt on,
#: coalescing on) with the capture plane armed, into its server's
#: directory.
CAPTURE_ENV = {"DBMT_CAPTURE": "1", "DBMT_CAPTURE_PATH": "capture.jsonl",
               "DBMT_CAPTURE_SNAP_S": "0.5"}


def check_capture(run: dict, same_traffic: dict) -> dict:
    """The capture of a mice run: its answers equal to ``same_traffic``'s
    (the same requests without capture); its records add up to what the
    run logged (a ``req`` per arrival, a ``rep`` per answer, a ``shed``
    per ``qos_shed``, a ``span`` per Result the miners wrote); its
    baseline's p50/p99 beside the clients' own; the replay plan's tenants
    and arrivals the traffic's."""
    from distributed_bitcoinminer_tpu_torch.apps.capture import (
        capture_baseline, load_capture, replay_plan)
    key = lambda r: [[m[0], m[1], m[2], m[3]] for m in r["mice"]]  # noqa
    if key(run) != key(same_traffic) or \
            (run["elephant"]["hash"], run["elephant"]["nonce"]) != \
            (same_traffic["elephant"]["hash"],
             same_traffic["elephant"]["nonce"]):
        fail(f"{run['tag']}: the captured run's answers differ from "
             f"{same_traffic['tag']}'s")
    path = os.path.join(os.path.dirname(run["server_log"]), "capture.jsonl")
    cap = load_capture(path)
    counts = scheduler_counts(run["server_log"])
    traffic = mice_traffic()
    arrivals = 2 + sum(len(m) for m in traffic)
    results = sum(read_counts(log).get("chunks", 0)
                  for log in run["miner_logs"])
    got = {"req": len(cap.reqs), "rep": len(cap.reps),
           "shed": len(cap.sheds), "span": len(cap.spans)}
    want = {"req": arrivals, "rep": counts["results_sent"],
            "shed": counts["qos_shed"], "span": results}
    if got != want:
        fail(f"{run['tag']}: capture records {got} != the run's {want}")
    base = capture_baseline(cap)
    plan = replay_plan(cap)
    sizes = sorted(n for t in plan for _, n, _, _ in t["reqs"])
    want_sizes = sorted([MICE_WARM_UP[1] + 1, ELEPHANT[1] + 1]
                        + [mx + 1 for m in traffic for _, mx in m])
    if len(plan) != 2 + len(traffic) or sizes != want_sizes:
        fail(f"{run['tag']}: replay plan of {len(plan)} tenants, sizes "
             f"{sizes[:5]}... != the traffic's")
    info = {"records": got, "baseline": base, "plan_tenants": len(plan),
            "plan_arrivals": len(sizes),
            "clients_p50_s": run["mice_p50_s"],
            "clients_p99_s": run["mice_p99_s"]}
    print(f"capture: {json.dumps(got)}; baseline p50 {base['p50_s']} s, "
          f"p99 {base['p99_s']} s (every reply: warm-up, elephant, mice) "
          f"beside the clients' mice p50 {run['mice_p50_s']} s, p99 "
          f"{run['mice_p99_s']} s", flush=True)
    return info


#: The replica path: a server of two scheduler replicas.
REPLICA_SERVER_ENV = {"DBMT_REPLICAS": "2", **MICE_SERVER_ENV}
REPLICAS_LINE = "replicas rollup "


def run_replicas(outdir: str) -> dict:
    """The replica path on a new server with ``DBMT_REPLICAS=2`` and two
    miners on card 0 (one a replica's slice): R1, R3, R4, then the 64
    mice of :func:`mice_traffic` from 8 connections at once. Returns the
    answers, the miners' launches, the job ids the server answered, and
    the rollup of the replicas' counters it logged when it stopped."""
    import asyncio

    from distributed_bitcoinminer_tpu_torch.apps.client import (
        submit, submit_until)
    by_name = {r[0]: r for r in ARGMIN_REQUESTS}
    results = []
    traffic = mice_traffic()
    with Cluster(outdir) as c:
        server_log = c.start("replicas_server", "server", [str(c.port)],
                             "Server listening on port",
                             env=REPLICA_SERVER_ENV)
        miners = start_miners(c, ["replicas_miner", "replicas_miner2"],
                              [None, None])
        for name in ("R1", "R3"):
            _, data, max_nonce = by_name[name]
            results.append(timed(name, data, max_nonce, lambda: asyncio.run(
                asyncio.wait_for(submit(c.hostport, data, max_nonce), 300))))
        name, data, max_nonce, target = UNTIL_REQUESTS[0]
        results.append(timed(name, data, max_nonce, lambda: asyncio.run(
            asyncio.wait_for(submit_until(c.hostport, data, max_nonce,
                                          target), 300))))

        async def mice():
            return await asyncio.gather(*(tenant_mice(c.hostport, m)
                                          for m in traffic))
        t0 = time.monotonic()
        tenants = asyncio.run(asyncio.wait_for(mice(), 300))
        mice_s = time.monotonic() - t0
        launches = path_launches(miners)
    with open(server_log, errors="replace") as f:
        text = f.read()
    rollup = None
    for line in text.splitlines():
        if REPLICAS_LINE in line:
            rollup = json.loads(line.split(REPLICAS_LINE, 1)[1])
    jobs = [int(j) for j in ANSWER_LINE.findall(text)]
    return {"requests": results, "launches": launches, "rollup": rollup,
            "jobs": jobs, "mice_seconds": mice_s,
            "mice": [[data, mx, h, n, sec] for t, m in zip(tenants, traffic)
                     for (data, mx), (h, n, sec) in zip(m, t["results"])],
            "tenants_disconnected": sum(t["disconnected"] for t in tenants)}


def check_replicas(run: dict, default: dict, mice: dict) -> None:
    """Every answer of the replica path equal to the default path's (R1,
    R3, R4) or the mice path's (each mouse, held there to the plain
    scan); both replicas answered (job ids from both ranges); the merged
    ``results_sent`` equal to the answers."""
    from distributed_bitcoinminer_tpu_torch.apps.replicas import ReplicaSet
    for r in run["requests"]:
        want = default[r["request"]]
        if (r["hash"], r["nonce"]) != (want["hash"], want["nonce"]):
            fail(f"replica path {r['request']}: {r['hash'], r['nonce']} != "
                 f"the default path's {want['hash'], want['nonce']}")
    want_mice = [m[:4] for m in mice["mice"]]
    if [m[:4] for m in run["mice"]] != want_mice \
            or run["tenants_disconnected"]:
        fail("replica path: the mice's answers differ from the mice path's")
    answers = len(run["requests"]) + len(run["mice"])
    ranges = {j // ReplicaSet.JOB_ID_STRIDE for j in run["jobs"]}
    if ranges != {0, 1}:
        fail(f"replica path: answers only from replicas {ranges}")
    if run["rollup"] is None \
            or run["rollup"].get("results_sent") != answers:
        fail(f"replica path: rollup {run['rollup']} != {answers} answers")
    if not (run["launches"]["K1"] and run["launches"]["K2"]
            and run["launches"]["K6"]):
        fail(f"replica path launched {run['launches']}")


#: The process tier's path (``apps.procs``): every process of it on the
#: card's host, the agents' miners on card 0 (``DBMT_COMPUTE`` unset), a
#: beat of 0.2 s, LSP epochs of 0.2 s (a dead replica's conns are lost
#: after 2 s), no result cache (each ring request reaches a miner) and no
#: audits.
PROCS_ENV = {"DBMT_HEALTH_BEAT_S": "0.2", "DBMT_EPOCH_MILLIS": "200",
             "DBMT_EPOCH_LIMIT": "10", "DBMT_CACHE": "0",
             "DBMT_AUDIT_P": "0", "DBMT_MESH_DEVICES": "cuda:0"}
#: About 5.5 s on one card: its owner is killed once it is granted.
PROCS_ELEPHANT = ("cmu440", (1 << 36) - 1)
LAUNCH_GAUGE = re.compile(
    r"miner\.kernel_launches\{kernel=(\w+),proc=(\w+)\}")


def dbmtop_doc(statedir: str) -> dict:
    """``tools/dbmtop.py --once --json`` as a subprocess."""
    out = subprocess.run(
        [sys.executable, "-m", f"{PKG}.tools.dbmtop", "--once", "--json",
         statedir], capture_output=True, text=True, timeout=60, cwd=ROOT)
    if out.returncode != 0:
        fail(f"dbmtop --once --json {statedir}: rc {out.returncode}, "
             f"{out.stderr[-2000:]!r}")
    return json.loads(out.stdout)


def proc_launches(doc: dict) -> dict:
    """Each process's kernel launches, from the launch gauges its rollup
    blob carries (fresh processes only)."""
    out: dict = {}
    for key, value in doc["cluster"].get("gauges", {}).items():
        m = LAUNCH_GAUGE.fullmatch(key)
        if m:
            out.setdefault(m.group(2), dict.fromkeys(KERNELS, 0))[
                m.group(1)] = int(value)
    return out


def replica_started(statedir: str, rid: int) -> int:
    """Requests replica ``rid`` has put in flight (its queue waits, from
    its rollup blob)."""
    from distributed_bitcoinminer_tpu_torch.apps.procs import read_json
    blob = read_json(os.path.join(statedir, f"metrics_replica_{rid}.json"))
    hist = (blob or {}).get("snapshot", {}).get("histograms", {}).get(
        "sched.queue_wait_s") or {}
    return hist.get("count", 0)


def ring_keys(statedir: str) -> dict:
    """A tenant key owned by each replica of the serving ring."""
    from distributed_bitcoinminer_tpu_torch.apps.procs import resolve_owner
    keys: dict = {}
    for i in range(1000):
        rid, _ = resolve_owner(statedir, f"tenant {i}")
        keys.setdefault(rid, f"tenant {i}")
    return keys


def run_procs(outdir: str) -> dict:
    """The procs path (the counterpart of the JAX package's
    ``scripts/procsmoke.py`` on the card): a ``ProcCluster`` of a router,
    2 replicas, a miner agent and a gateway agent with 2 children, started
    in that order so the miner agent joins replica 0 and the gateway
    replica 1; R1, R3 and R4 through ``submit_with_retry("ring:...")``
    with a tenant key owned by each replica; ``dbmtop --once --json``;
    the elephant, its owner killed with ``kill -9`` once it is granted;
    ``dbmtop`` again. Then one host-tier miner agent
    (``DBMT_COMPUTE=host``) on a ring of its own serves R1."""
    import asyncio

    from distributed_bitcoinminer_tpu_torch.apps import procs
    from distributed_bitcoinminer_tpu_torch.apps.client import \
        submit_with_retry
    from distributed_bitcoinminer_tpu_torch.lsp.params import Params
    from distributed_bitcoinminer_tpu_torch.utils.config import RetryParams
    params = Params(epoch_limit=10, epoch_millis=200)
    retry = RetryParams(attempts=6, timeout_s=0, backoff_s=0.2)

    def ring(statedir, data, max_nonce, target=0, key=None):
        return asyncio.run(asyncio.wait_for(submit_with_retry(
            f"ring:{statedir}", data, max_nonce, target, params, retry,
            tenant_key=key), 300))

    def cluster(tag: str, **kw):
        statedir = os.path.join(outdir, f"{tag}_state")
        shutil.rmtree(statedir, ignore_errors=True)
        logdir = os.path.join(outdir, f"{tag}_logs")
        shutil.rmtree(logdir, ignore_errors=True)
        c = procs.ProcCluster(statedir, logdir=logdir, **kw)
        c.env.pop("DBMT_COMPUTE", None)
        c.env.update(PROCS_ENV, PYTHONPATH=ROOT + os.pathsep
                     + os.environ.get("PYTHONPATH", ""))
        return c

    by_name = {r[0]: r for r in ARGMIN_REQUESTS}
    c = cluster("procs", replicas=2, miners=0, gateways=0, children=2)
    t0 = time.monotonic()
    try:
        c.start()
        c.spawn_miner(0)
        asyncio.run(c.wait_live(2, timeout_s=300, miners=1))
        c.spawn_gateway(0)
        m0 = asyncio.run(c.wait_live(2, timeout_s=300, miners=2))
        start_s = time.monotonic() - t0
        keys = ring_keys(c.statedir)
        results = []
        for rid, key in sorted(keys.items()):
            for name in ("R1", "R3"):
                _, data, max_nonce = by_name[name]
                r = timed(name, data, max_nonce,
                          lambda: ring(c.statedir, data, max_nonce, key=key))
                results.append({**r, "replica": rid, "tenant_key": key})
            name, data, max_nonce, target = UNTIL_REQUESTS[0]
            r = timed(name, data, max_nonce, lambda: ring(
                c.statedir, data, max_nonce, target, key))
            results.append({**r, "replica": rid, "tenant_key": key})
        time.sleep(0.5)                   # one more blob of each process
        before = dbmtop_doc(c.statedir)
        data, max_nonce = PROCS_ELEPHANT
        owner, _ = procs.resolve_owner(c.statedir, data)
        started0 = replica_started(c.statedir, owner)

        async def elephant():
            job = asyncio.ensure_future(submit_with_retry(
                f"ring:{c.statedir}", data, max_nonce, 0, params, retry))
            t_sub = time.monotonic()
            while replica_started(c.statedir, owner) <= started0:
                if job.done() or time.monotonic() - t_sub > 60:
                    fail("procs path: the elephant was never granted before "
                         "its answer")
                await asyncio.sleep(0.02)
            granted_s = time.monotonic() - t_sub
            if not c.kill_replica(owner):
                fail(f"procs path: replica {owner} was not running")
            t_kill = time.monotonic()
            fence_s = None
            while not job.done():
                m = c.membership()
                if fence_s is None and m is not None and m.epoch > m0.epoch:
                    fence_s = time.monotonic() - t_kill
                await asyncio.sleep(0.02)
            reply_s = time.monotonic() - t_kill
            return (await job, granted_s, fence_s, reply_s)
        got, granted_s, fence_s, reply_s = asyncio.run(
            asyncio.wait_for(elephant(), 600))
        answer = None if got is None else {
            "data": data, "max_nonce": max_nonce, "hash": got[0],
            "nonce": got[1]}
        m1 = c.membership()
        time.sleep(0.5)
        after = dbmtop_doc(c.statedir)
    finally:
        c.close()
    host = cluster("procs_host", replicas=1, miners=1, gateways=0)
    host.env["DBMT_COMPUTE"] = "host"
    try:
        host.start()
        asyncio.run(host.wait_live(1, timeout_s=300, miners=1))
        _, data, max_nonce = by_name["R1"]
        host_r1 = timed("R1 host", data, max_nonce,
                        lambda: ring(host.statedir, data, max_nonce))
        time.sleep(0.5)
        host_doc = dbmtop_doc(host.statedir)
    finally:
        host.close()
    return {"start_s": start_s, "requests": results,
            "keys": {str(k): v for k, v in keys.items()},
            "epoch_before": m0.epoch, "live_before": sorted(m0.live),
            "owner": owner,
            "owner_incarnation": m0.live[owner]["incarnation"],
            "elephant": answer,
            "granted_s": granted_s, "fence_s": fence_s, "reply_s": reply_s,
            "epoch_after": m1.epoch, "live_after": sorted(m1.live),
            "fenced_after": m1.is_fenced(owner,
                                         m0.live[owner]["incarnation"]),
            "dbmtop_before": before, "dbmtop_after": after,
            "launches_by_proc": proc_launches(after),
            "host_r1": host_r1,
            "host_launches_by_proc": proc_launches(host_doc),
            "host_roles": sorted(p["role"] for p in host_doc["procs"])}


def check_procs(run: dict, default: dict, dev) -> dict:
    """The procs path's checks; returns its summary for the report."""
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
    if set(run["keys"]) != {"0", "1"}:
        fail(f"procs path: the serving ring is {run['keys']}, not both "
             "replicas")
    for r in run["requests"]:
        want = default[r["request"]]
        if (r["hash"], r["nonce"]) != (want["hash"], want["nonce"]):
            fail(f"procs path {r['request']} via replica {r['replica']}: "
                 f"{r['hash'], r['nonce']} != the default path's "
                 f"{want['hash'], want['nonce']}")
    want = default["R1"]
    if (run["host_r1"]["hash"], run["host_r1"]["nonce"]) != \
            (want["hash"], want["nonce"]):
        fail(f"procs path: the host tier's R1 {run['host_r1']} != the "
             f"card's {want['hash'], want['nonce']}")
    if any(any(v.values()) for v in run["host_launches_by_proc"].values()) \
            or run["host_roles"] != ["miner", "replica", "router"]:
        fail(f"procs path: the host tier's processes {run['host_roles']} "
             f"launched {run['host_launches_by_proc']}")
    el = run["elephant"]
    if el is None:
        fail("procs path: the elephant got no answer")
    data, max_nonce = PROCS_ELEPHANT
    direct = NonceSearcher(data, device=dev).search(0, max_nonce + 1)
    if (el["hash"], el["nonce"]) != direct:
        fail(f"procs path: the elephant {el['hash'], el['nonce']} != a "
             f"direct search on card 0 {direct}")
    if not (run["epoch_after"] > run["epoch_before"] and run["fenced_after"]
            and run["live_after"] == [1 - run["owner"]]
            and run["fence_s"] is not None):
        fail(f"procs path: the router did not fence replica {run['owner']}: "
             f"epoch {run['epoch_before']} -> {run['epoch_after']}, live "
             f"{run['live_after']}")
    before, after = run["dbmtop_before"], run["dbmtop_after"]
    roles = sorted(p["role"] for p in before["procs"])
    if roles != ["gateway", "miner", "replica", "replica", "router"] \
            or any(p["status"] != "fresh" for p in before["procs"]):
        fail(f"procs path: dbmtop before the kill: "
             f"{[(p['proc'], p['status']) for p in before['procs']]}")
    beat = float(PROCS_ENV["DBMT_HEALTH_BEAT_S"])
    max_age = max(p["age_s"] for p in before["procs"])
    dead = f"replica{run['owner']}"
    rows = {p["proc"]: p for p in after["procs"]}
    if rows.get(dead, {}).get("status") not in ("fenced", "stale") \
            or f"proc={dead}" in json.dumps(after["cluster"]):
        fail(f"procs path: after the kill dbmtop shows {rows.get(dead)}")
    survivor = f"replica{1 - run['owner']}"
    prior = {p["proc"]: p for p in before["procs"]}[survivor]
    answered = rows[survivor]["detail"].get("results", 0) \
        - prior["detail"].get("results", 0)
    if answered != 1:
        fail(f"procs path: the survivor answered {answered} requests after "
             "the kill, not the elephant once")
    if [s["objective"] for s in after["slo"]] != \
            ["reply_availability", "queue_wait_p99", "shed_rate"]:
        fail(f"procs path: dbmtop's slo list {after['slo']}")
    by_proc = run["launches_by_proc"]
    agents = {p: n for p, n in by_proc.items()
              if p.startswith(("miner", "gateway"))}
    if sorted(p.rstrip("0123456789") for p in agents) != ["gateway", "miner"]:
        fail(f"procs path: launches by process {by_proc}")
    for proc, n in agents.items():
        if not (n["K1"] and n["K6"] and n["K2"]):
            fail(f"procs path: {proc} launched {n}")
    if set(by_proc) - set(agents):
        fail(f"procs path: launches outside the agents {by_proc}")
    return {"launches": {k: sum(n[k] for n in agents.values())
                         for k in KERNELS},
            "max_age_before_s": max_age, "beat_s": beat}


#: The gateway path: the gateway joins its parent once both children have
#: joined, and re-sends its JOIN at most every 0.5 s.
GATEWAY_ENV = {"DBMT_GATEWAY_MIN_POOL": "2", "DBMT_GATEWAY_HINT_S": "0.5"}
GATEWAY_WARM = ("gateway warm", (1 << 34) - 1)
HINT_LINE = re.compile(r"rate hint ([0-9.e+]+) nonces/s")


def run_gateway(outdir: str) -> dict:
    """The gateway path: a stock port server as the parent, ``python -m
    ...apps.gateway <parent>`` and two miner CLIs on ``cuda`` (rate hints
    by probe) behind its inner port; a warm request that gives the inner
    pool its measured rates (so the gateway refreshes its hint), then R1,
    R3 and R4 through the parent."""
    import asyncio

    from distributed_bitcoinminer_tpu_torch.apps.client import (
        submit, submit_until)
    by_name = {r[0]: r for r in ARGMIN_REQUESTS}
    results = []
    with Cluster(outdir) as c:
        parent_log = c.start("gw_parent", "server", [str(c.port)],
                             "Server listening on port")
        gw_dir = server_dir(outdir, "gw_gateway")
        shutil.rmtree(gw_dir, ignore_errors=True)
        os.makedirs(gw_dir)
        gw_out = c.launch("gw_gateway", ["-m", f"{PKG}.apps.gateway",
                                         c.hostport], GATEWAY_ENV,
                          cwd=gw_dir)
        wait_for_line(gw_out, "Gateway inner tier listening on port",
                      c.procs[-1], timeout=120)
        with open(gw_out) as f:
            port = int(re.search(r"listening on port (\d+)",
                                 f.read()).group(1))
        inner = f"127.0.0.1:{port}"
        miners = []
        for name in ("gw_child", "gw_child2"):
            miners.append(c.start(name, "miner", [inner, "--device", "cuda"],
                                  "joined ", env={"DBMT_RATE_HINT": "probe"}))
        wait_until("the gateway's JOIN", lambda: " joined" in open(
            parent_log, errors="replace").read(), c.procs[0])
        data, max_nonce = GATEWAY_WARM
        results.append(timed("warm", data, max_nonce, lambda: asyncio.run(
            asyncio.wait_for(submit(c.hostport, data, max_nonce), 300))))
        wait_until("the gateway's hint refresh", lambda: "refreshed rate hint"
                   in open(parent_log, errors="replace").read(), c.procs[0],
                   timeout=60)
        for name in ("R1", "R3"):
            _, data, max_nonce = by_name[name]
            results.append(timed(name, data, max_nonce, lambda: asyncio.run(
                asyncio.wait_for(submit(c.hostport, data, max_nonce), 300))))
        name, data, max_nonce, target = UNTIL_REQUESTS[0]
        results.append(timed(name, data, max_nonce, lambda: asyncio.run(
            asyncio.wait_for(submit_until(c.hostport, data, max_nonce,
                                          target), 300))))
        launches = path_launches(miners)
    with open(parent_log, errors="replace") as f:
        parent = f.read()
    with open(os.path.join(gw_dir, "log.txt"), errors="replace") as f:
        gw_text = f.read()
    child_hints = []
    for log in miners:
        with open(log, errors="replace") as f:
            m = HINT_LINE.search(f.read())
        child_hints.append(float(m.group(1)) if m else None)
    joins = re.findall(r"miner (\d+) joined(?: with rate hint "
                       r"([0-9.e+]+) nonces/s)?", parent)
    gw_join = re.search(r"joined the parent as one miner \(pool (\d+), hint "
                        r"([0-9.e+]+) nonces/s\)", gw_text)
    return {"requests": results, "launches": launches,
            "parent_joins": joins,
            "parent_refreshes": re.findall(
                r"miner (\d+) refreshed rate hint ([0-9.e+]+) nonces/s",
                parent),
            "gateway_join": None if gw_join is None else
            {"pool": int(gw_join.group(1)), "hint": float(gw_join.group(2))},
            "gateway_refreshes": len(re.findall(r"refreshed its hint",
                                                gw_text)),
            "child_hints": child_hints,
            "parent_counts": scheduler_counts(parent_log)}


def check_gateway(run: dict, default: dict) -> None:
    for r in run["requests"]:
        if r["request"] == "warm":
            continue
        want = default[r["request"]]
        if (r["hash"], r["nonce"]) != (want["hash"], want["nonce"]):
            fail(f"gateway path {r['request']}: {r['hash'], r['nonce']} != "
                 f"the default path's {want['hash'], want['nonce']}")
    # A repeat JOIN's hint replaces the parent's EWMA only while it is a
    # claim or 2x off a measured rate (``rate_hints_refreshed`` counts
    # those); every repeat JOIN is logged as a refresh of the one entry.
    counts = run["parent_counts"]
    if counts.get("claims_failed", 1) != 0:
        fail(f"gateway path: the parent's counts {counts}")
    joins, gw = run["parent_joins"], run["gateway_join"]
    if len(joins) != 1 or not run["parent_refreshes"] \
            or {c for c, _ in run["parent_refreshes"]} != {joins[0][0]}:
        fail(f"gateway path: the parent saw joins {joins} and refreshes "
             f"{run['parent_refreshes']}")
    # The JOIN's hint is the inner pool's sum: both children's probed
    # hints, each less the 2% a sweep (one a second) that an unconfirmed
    # hint decays between its child's JOIN and the gateway's.
    hints = run["child_hints"]
    if gw is None or gw["pool"] != 2 or None in hints \
            or not max(hints) < gw["hint"] <= sum(hints) * (1 + 1e-5) \
            or gw["hint"] < sum(hints) * 0.98 ** 30 or not joins[0][1] \
            or abs(float(joins[0][1]) - gw["hint"]) > 5e-3 * gw["hint"]:
        fail(f"gateway path: the JOIN hint {joins[0][1]} / the gateway's "
             f"{gw} against the children's {hints}")
    if not (run["launches"]["K1"] and run["launches"]["K6"]
            and run["launches"]["K2"]):
        fail(f"gateway path launched {run['launches']}")


#: The lease path's server: 2 s leases on a cold pool (and as the floor on
#: a warm one), a sweep every 0.1 s, the age alarms after 1 s, no audits.
LEASE_SERVER_ENV = {"DBMT_LEASE_GRACE_S": "2", "DBMT_LEASE_FLOOR_S": "2",
                    "DBMT_LEASE_TICK_S": "0.1", "DBMT_QUEUE_ALARM_S": "1",
                    "DBMT_AUDIT_P": "0", **METRICS_ENV}
#: The verification path's server: every arg-min chunk audited, over its
#: whole range (an honest audit restores the exact chunk arg-min).
VERIFY_SERVER_ENV = {"DBMT_AUDIT_P": "1", "DBMT_AUDIT_MAX": str(1 << 32),
                     **METRICS_ENV}
#: The server's lines each path counts.
LEASE_LINES = {"blown": "blew the lease", "reissued": "speculatively re-issuing",
               "quarantined": "quarantined after",
               "lifted": "quarantine lifted", "inflight_alarms": "in flight for",
               "queue_alarms": "queued for"}
VERIFY_LINES = {"audit_failed": "FAILED an audit",
                "claim_failed": "FAILED the claim check"}


def fault_miner(mode: str, hostport: str) -> int:
    """``--fault-miner MODE HOSTPORT``: the port's ``MinerWorker`` on card 0
    (warmed up as the miner CLI does), each searcher
    ``default_searcher_factory(data, "cuda")`` wrapped in the port's
    ``WedgeableSearcher`` (``wedge``: its gate clear until SIGUSR1 sets
    it) or ``ByzantineSearcher`` (``sentinel``, ``wrong_hash``: its lie
    flag set). It logs as the miner CLI does. It exists for the lease and
    verification paths; the miner CLI has no fault knob."""
    import asyncio
    import logging
    import signal
    import threading
    sys.path.insert(0, ROOT)
    from distributed_bitcoinminer_tpu_torch.apps.miner import (
        MinerWorker, default_searcher_factory, warm_up)
    from distributed_bitcoinminer_tpu_torch.lsp.params import Params
    from distributed_bitcoinminer_tpu_torch.lspnet.chaos import (
        ByzantineSearcher, WedgeableSearcher)
    from distributed_bitcoinminer_tpu_torch.utils.config import \
        coalesce_from_env
    if mode not in ("wedge", "sentinel", "wrong_hash"):
        print(f"chip_smoke: unknown fault {mode!r}", file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    warm_up("cuda")
    gate, lie = threading.Event(), threading.Event()
    lie.set()

    def factory(data):
        inner = default_searcher_factory(data, "cuda")
        return WedgeableSearcher(inner, gate) if mode == "wedge" \
            else ByzantineSearcher(inner, data, mode, lie)

    async def serve():
        asyncio.get_running_loop().add_signal_handler(signal.SIGUSR1,
                                                      gate.set)
        worker = MinerWorker(hostport, params=Params(),
                             searcher_factory=factory,
                             coalesce=coalesce_from_env().enabled)
        try:
            await worker.join()
            logging.getLogger("dbmt.miner").info(
                "joined %s on cuda (%s)", hostport, mode)
            await worker.run()
        finally:
            await worker.close()
    asyncio.run(serve())
    return 0


def count_lines(log_path: str, lines: dict) -> dict:
    with open(log_path, errors="replace") as f:
        text = f.read()
    return {name: text.count(line) for name, line in lines.items()}


def scheduler_counts(log_path: str) -> dict:
    """The server's last ``scheduler counts`` line (its counters after
    its last answer)."""
    last = {}
    with open(log_path, errors="replace") as f:
        for line in f:
            if "scheduler counts " in line:
                last = json.loads(line.split("scheduler counts ", 1)[1])
    return last


def wait_until(what: str, cond, proc, timeout: float = 120) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if proc.poll() is not None or time.monotonic() > deadline:
            fail(f"{what} never happened")
        time.sleep(0.1)


def argmin_submit(c: Cluster, name: str, data: str, max_nonce: int):
    import asyncio

    from distributed_bitcoinminer_tpu_torch.apps.client import submit
    return timed(name, data, max_nonce, lambda: asyncio.run(
        asyncio.wait_for(submit(c.hostport, data, max_nonce), 300)))


def run_lease(outdir: str) -> dict:
    """The lease path on a new server (``LEASE_SERVER_ENV``): a wedged
    miner W joins first, then one miner A through the CLI. R4: W's chunk 0
    blows its lease and goes, with its target, to A; R3 twice: W's third
    blown lease quarantines it; R1: A alone, one chunk; then SIGUSR1
    releases W, which serves its three blown chunks late (they pop as
    stale and lift the quarantine); R1 again splits over both."""
    import asyncio
    import signal

    from distributed_bitcoinminer_tpu_torch.apps.client import submit_until
    by_name = {r[0]: r for r in ARGMIN_REQUESTS}
    r4 = UNTIL_REQUESTS[0]
    results = []
    with Cluster(outdir) as c:
        server_log = c.start("lease_server", "server", [str(c.port)],
                             "Server listening on port",
                             env=LEASE_SERVER_ENV)
        w_log = c.spawn_fault_miner("lease_wedged", "wedge")
        w_proc = c.procs[-1]
        wait_for_line(w_log, "joined ", w_proc)
        a_logs = start_miners(c, ["lease_miner"], [None])
        if read_counts(w_log):
            fail("the wedged miner's counts were not 0 before its path")
        results.append(timed("R4", *r4[1:3], lambda: asyncio.run(
            asyncio.wait_for(submit_until(c.hostport, *r4[1:]), 300))))
        for _ in range(2):
            results.append(argmin_submit(c, *by_name["R3"]))
        results.append(argmin_submit(c, *by_name["R1"]))
        held = served_chunks([w_log])
        t_signal = time.monotonic()
        w_proc.send_signal(signal.SIGUSR1)
        wait_for_line(server_log, LEASE_LINES["lifted"], w_proc)
        wait_until("the wedged miner's three late chunks",
                   lambda: len(served_chunks([w_log])) >= 3, w_proc)
        late_s = time.monotonic() - t_signal
        results.append(argmin_submit(c, "R1 again", *by_name["R1"][1:]))
        launches = {"wedged": path_launches([w_log]),
                    "miner": path_launches(a_logs)}
        chunks = {"wedged": served_chunks([w_log]),
                  "miner": served_chunks(a_logs)}
        lines = count_lines(server_log, LEASE_LINES)
        counts = scheduler_counts(server_log)
    return {"requests": results, "launches": launches, "chunks": chunks,
            "server_log": server_log,
            "wedged_served_before_release": len(held),
            "late_chunks_s": late_s, "server_lines": lines,
            "scheduler_counts": counts}


def check_lease(run: dict, default: dict) -> None:
    """Every answer equal to the same request's on the default paths; the
    server's lines: blown leases and re-issues, a quarantine, its lifting
    and the in-flight alarm; W served nothing until released, then its
    three blown chunks and R1 again's chunk 0, through the kernels; A
    served R1 as one chunk."""
    names = [r["request"] for r in run["requests"]]
    if names != ["R4", "R3", "R3", "R1", "R1 again"]:
        fail(f"lease path: requests {names}")
    for r in run["requests"]:
        want = default[r["request"]]
        if (r["hash"], r["nonce"]) != (want["hash"], want["nonce"]):
            fail(f"lease path {r['request']}: {r['hash'], r['nonce']} != "
                 f"the default path's {want['hash'], want['nonce']}")
    lines = run["server_lines"]
    if lines["blown"] < 3 or lines["reissued"] < 3 \
            or not lines["quarantined"] or not lines["lifted"] \
            or not lines["inflight_alarms"]:
        fail(f"lease path: the server logged {lines}")
    _, data, max_nonce = next(r for r in ARGMIN_REQUESTS if r[0] == "R1")
    whole, half = [data, 0, max_nonce + 1], [data, 0, (max_nonce + 1) // 2]
    wedged, miner = run["chunks"]["wedged"], run["chunks"]["miner"]
    if run["wedged_served_before_release"] or len(wedged) != 4 \
            or wedged[3] != half or whole not in miner:
        fail(f"lease path: the wedged miner served {wedged} "
             f"({run['wedged_served_before_release']} before its "
             f"release), the other {miner}")
    w = run["launches"]["wedged"]
    if not (w["K1"] and w["K2"] and w["K6"]) or w["K3"] or w["K4"]:
        fail(f"lease path: the wedged miner launched {w}")


def run_verify(outdir: str) -> dict:
    """The verification path on a new server (``VERIFY_SERVER_ENV``): two
    miners through the CLI and two liars (``sentinel``, ``wrong_hash``),
    R3, R1, R3; each miner's served chunks read before the last request
    and after it."""
    by_name = {r[0]: r for r in ARGMIN_REQUESTS}
    results = []
    with Cluster(outdir) as c:
        server_log = c.start("verify_server", "server", [str(c.port)],
                             "Server listening on port",
                             env=VERIFY_SERVER_ENV)
        logs = {"sentinel": c.spawn_fault_miner("verify_sentinel",
                                                "sentinel"),
                "wrong_hash": c.spawn_fault_miner("verify_wrong_hash",
                                                  "wrong_hash"),
                "miner": c.spawn("verify_miner", "miner",
                                 [c.hostport, "--device", "cuda"]),
                "miner2": c.spawn("verify_miner2", "miner",
                                  [c.hostport, "--device", "cuda"])}
        for (name, log), proc in zip(logs.items(), c.procs[-4:]):
            wait_for_line(log, "joined ", proc)
            if read_counts(log):
                fail(f"verification path: {name}'s counts were not 0")
        results.append(argmin_submit(c, *by_name["R3"]))
        results.append(argmin_submit(c, *by_name["R1"]))
        time.sleep(0.5)
        before = {n: len(served_chunks([log])) for n, log in logs.items()}
        results.append(argmin_submit(c, *by_name["R3"]))
        launches = {n: path_launches([log]) for n, log in logs.items()}
        after = {n: len(served_chunks([log])) for n, log in logs.items()}
        lines = count_lines(server_log, VERIFY_LINES)
        counts = scheduler_counts(server_log)
        with open(server_log, errors="replace") as f:
            trust = re.findall(r"miner (\d+) FAILED .*\(trust -> "
                               r"([0-9.e-]+)\)", f.read())
    return {"requests": results, "launches": launches,
            "server_log": server_log,
            "served_before_last": before, "served_after_last": after,
            "server_lines": lines, "scheduler_counts": counts,
            "trust_after_failures": [[int(m), float(t)] for m, t in trust]}


def check_verify(run: dict, default: dict) -> None:
    """Every answer equal to the default path's; a failed audit and a
    failed claim in the server's log; in the last request neither liar
    served a chunk (both below the trust bar) and the two miners served
    it through the kernels."""
    for r in run["requests"]:
        want = default[r["request"]]
        if (r["hash"], r["nonce"]) != (want["hash"], want["nonce"]):
            fail(f"verification path {r['request']}: "
                 f"{r['hash'], r['nonce']} != the default path's "
                 f"{want['hash'], want['nonce']}")
    if not (run["server_lines"]["audit_failed"]
            and run["server_lines"]["claim_failed"]):
        fail(f"verification path: the server logged "
             f"{run['server_lines']}")
    before, after = run["served_before_last"], run["served_after_last"]
    for liar in ("sentinel", "wrong_hash"):
        if after[liar] != before[liar]:
            fail(f"verification path: the {liar} liar served "
                 f"{after[liar] - before[liar]} chunks of the last request")
    for name in ("miner", "miner2"):
        counts = run["launches"][name]
        if after[name] <= before[name] or not (counts["K1"] and counts["K6"]):
            fail(f"verification path: {name} served {after[name]} chunks, "
                 f"launched {counts}")
    bar = 0.2    # VerifyParams.trust_bar
    convicted = {m for m, t in run["trust_after_failures"] if t < bar}
    if len(convicted) < 2:
        fail(f"verification path: miners below the trust bar {convicted}, "
             f"from {run['trust_after_failures']}")


#: The sched path's first server: striping in chunks of 0.05 s, so each
#: miner's 2^31 share of R3 (about 0.17 s of work) is several chunks.
#: The wholesale bound is raised from 5 s to 60 s because of a known
#: fault of the probe: its 2^17 nonces are launch-bound on an H100, so
#: the cold pool's only rate, the probe's hint, is 20-30x below the
#: steady rate; R3 would be estimated at about 10 s and chunked by the
#: QoS plane, not dispatched wholesale and striped (ROADMAP).
SCHED_SERVER_ENV = {"DBMT_CACHE": "1", "DBMT_STRIPE_CHUNK_S": "0.05",
                    "DBMT_QOS_WHOLESALE_S": "60"}
#: The first server's miners: one probes its rate before joining.
SCHED_MINER_ENVS = [{"DBMT_RATE_HINT": "probe"}, None]
#: The message of the third request, over 2^32 on the warm pool.
SCHED_WARM = ("sched warm pool", (1 << 33) - 1)
#: The second server: chunked from 0.1 s in 0.05 s chunks (as the mice
#: path), one admission token per tenant (burst 1, refilled once in 100
#: s), at most one request queued, and weights by conn id. The LSP server
#: numbers conns from 1 in the order they connect, miners and clients
#: alike: the two miners are 1 and 2, the warm-up's client 3, then the
#: elephant (4), one tenant writing two mice at once (5: its second is
#: shed at admission), four tenants writing a mouse each at once (6-9:
#: beyond one queued, the oldest is shed), and last the weights' two
#: tenants (10 and 11). The weights come last, once the elephant is
#: answered, so their two tenants contend only with each other.
SCHED_ELEPHANT_CONN, SCHED_ADMISSION_CONN, SCHED_OVERLOAD_CONN = 4, 5, 6
SCHED_WEIGHT_LIGHT, SCHED_WEIGHT_HEAVY = 10, 11
SCHED_QOS_ENV = {"DBMT_CACHE": "1", "DBMT_QOS_WHOLESALE_S": "0.1",
                 "DBMT_QOS_CHUNK_S": "0.05", "DBMT_QOS_RATE": "0.01",
                 "DBMT_QOS_BURST": "1", "DBMT_QOS_MAX_QUEUED": "1",
                 "DBMT_QOS_WEIGHTS": f"{SCHED_WEIGHT_LIGHT}:1,"
                                     f"{SCHED_WEIGHT_HEAVY}:3"}
#: The weights' two elephants, about 0.7 s of the pool each.
SCHED_ELEPHANTS = {SCHED_WEIGHT_LIGHT: ("weight one", (1 << 33) - 1),
                   SCHED_WEIGHT_HEAVY: ("weight three", (1 << 33) - 1)}
SCHED_ADMISSION_MICE = (("admission a", 10 ** 5 - 1),
                        ("admission b", 10 ** 5 - 1))
SCHED_OVERLOAD_MICE = tuple((f"overload {j}", 10 ** 5 - 1)
                            for j in range(4))
SHED_LINE = re.compile(r"QoS shed \((\w+)\): request .* from tenant (\d+) "
                       r"\(\+(\d+) queued")


async def open_tenants(hostport: str, n: int, first_conn: int) -> list:
    """``n`` client connections, opened one after another, so the server
    numbers them ``first_conn``, ``first_conn + 1``, ...; fails
    otherwise."""
    from distributed_bitcoinminer_tpu_torch.lsp.client import \
        new_async_client
    clients = []
    for j in range(n):
        client = await new_async_client(hostport)
        if client.conn_id() != first_conn + j:
            fail(f"sched path: conn {client.conn_id()} where "
                 f"{first_conn + j} was expected")
        clients.append(client)
    return clients


async def tenant_results(client, requests: tuple, t0: float) -> dict:
    """Write ``requests`` ``(data, max_nonce)`` at once on ``client`` and
    read their Results: ``{"results": [[hash, nonce, seconds], ...],
    "disconnected": bool}`` (the connection lost before every Result
    came, as the client CLI's ``Disconnected``)."""
    from distributed_bitcoinminer_tpu_torch.bitcoin.message import (
        Message, MsgType, new_request)
    from distributed_bitcoinminer_tpu_torch.lsp.errors import LspError
    for data, max_nonce in requests:
        client.write(new_request(data, 0, max_nonce).to_json())
    out, lost = [], False
    try:
        while len(out) < len(requests):
            msg = Message.from_json(await client.read())
            if msg.type == MsgType.RESULT:
                out.append([msg.hash, msg.nonce, time.monotonic() - t0])
    except LspError:
        lost = True
    finally:
        await client.close()
    return {"conn": client.conn_id(), "requests": [list(r) for r in requests],
            "results": out, "disconnected": lost}


def run_sched(outdir: str, adapt: bool) -> dict:
    """The sched path: the scheduler's striping, rate-hint JOIN, result
    cache, admission, shedding and weights, on two new servers of two
    miners each, their adapt plane on or off (``DBMT_ADAPT``). The first
    (``SCHED_SERVER_ENV``; one miner probes its rate,
    ``DBMT_RATE_HINT=probe``): R3 on the cold pool, striped from the
    hint; R3 again, from the cache; ``SCHED_WARM`` on the warm pool; R4.
    The second (``SCHED_QOS_ENV``): a warm-up, the elephant and, while it
    runs, a tenant shed at admission and four writing at once past the
    queue's bound; then the weights' two elephants (the light one written
    first)."""
    import asyncio

    from distributed_bitcoinminer_tpu_torch.apps.client import (
        submit, submit_until)
    by_name = {r[0]: r for r in ARGMIN_REQUESTS}
    r4 = UNTIL_REQUESTS[0]
    tag = "sched_adapt" if adapt else "sched"
    adapt_env = {"DBMT_ADAPT": "1" if adapt else "0"}
    out = {"tag": tag, "adapt": {}}
    with Cluster(outdir) as c:
        server_log = c.start(f"{tag}_server", "server", [str(c.port)],
                             "Server listening on port",
                             env={**SCHED_SERVER_ENV, **adapt_env})
        miners = start_miners(c, [f"{tag}_probe_miner", f"{tag}_miner"],
                              SCHED_MINER_ENVS)
        with open(miners[0], errors="replace") as f:
            hint = re.search(r"rate hint ([0-9.e+]+) nonces/s", f.read())
        if hint is None:
            fail("sched path: the probing miner logged no rate hint")
        steps, striped, counts = [], [], {}
        launches = []
        for name, submit_fn in (
                ("R3", lambda: asyncio.run(asyncio.wait_for(
                    submit(c.hostport, *by_name["R3"][1:]), 300))),
                ("R3 again", lambda: asyncio.run(asyncio.wait_for(
                    submit(c.hostport, *by_name["R3"][1:]), 300))),
                ("warm", lambda: asyncio.run(asyncio.wait_for(
                    submit(c.hostport, *SCHED_WARM), 300))),
                ("R4", lambda: asyncio.run(asyncio.wait_for(
                    submit_until(c.hostport, *r4[1:]), 300)))):
            launches.append(path_launches(miners))
            data, max_nonce = (SCHED_WARM if name == "warm"
                               else by_name["R3"][1:] if name != "R4"
                               else r4[1:3])
            steps.append(timed(name, data, max_nonce, submit_fn))
            time.sleep(0.2)
            counts = scheduler_counts(server_log)
            striped.append(counts.get("chunks_striped", 0))
        launches.append(path_launches(miners))
        with open(server_log, errors="replace") as f:
            text = f.read()
        out["striping"] = {
            "requests": steps, "rate_hint": float(hint.group(1)),
            "chunks_striped_after_each": striped,
            "launches_before_each": launches,
            "launches_by_miner": {os.path.basename(m): path_launches([m])
                                  for m in miners},
            "chunks_by_miner": {os.path.basename(m): len(served_chunks([m]))
                                for m in miners},
            "cache_replay_logged": "answered from the result cache" in text,
            "prefix_release_logged": "(prefix release)" in text,
            "hint_joined_logged": "joined with rate hint" in text,
            "scheduler_counts": counts}
        out["adapt"]["striping"] = adapt_state(server_log)
        first_miners = miners
    with Cluster(outdir) as c:
        server_log = c.start(f"{tag}_qos_server", "server", [str(c.port)],
                             "Server listening on port",
                             env={**SCHED_QOS_ENV, **adapt_env})
        miners = start_miners(c, [f"{tag}_qos_miner", f"{tag}_qos_miner2"],
                              [None, None])
        warm = timed("warm-up", *MICE_WARM_UP, lambda: asyncio.run(
            asyncio.wait_for(submit(c.hostport, *MICE_WARM_UP), 300)))

        async def drive():
            (el,) = await open_tenants(c.hostport, 1, SCHED_ELEPHANT_CONN)
            t0 = time.monotonic()
            el_task = asyncio.create_task(tenant_results(el, (ELEPHANT,),
                                                         t0))
            await asyncio.sleep(0.3)
            (adm,) = await open_tenants(c.hostport, 1, SCHED_ADMISSION_CONN)
            adm_task = asyncio.create_task(tenant_results(
                adm, SCHED_ADMISSION_MICE, time.monotonic()))
            over = await open_tenants(c.hostport, len(SCHED_OVERLOAD_MICE),
                                      SCHED_OVERLOAD_CONN)
            t1 = time.monotonic()
            overload = asyncio.gather(*(
                tenant_results(cl, (mouse,), t1)
                for cl, mouse in zip(over, SCHED_OVERLOAD_MICE)))
            # The weights once the elephant is answered, while the shed
            # clients still wait to see their connections die.
            el_res = await el_task
            light, heavy = await open_tenants(c.hostport, 2,
                                              SCHED_WEIGHT_LIGHT)
            t0 = time.monotonic()
            weights = await asyncio.gather(*(
                tenant_results(cl, (SCHED_ELEPHANTS[cl.conn_id()],), t0)
                for cl in (light, heavy)))
            return weights, el_res, await adm_task, await overload
        weights, el, adm, overload = asyncio.run(asyncio.wait_for(drive(),
                                                                  300))
        time.sleep(0.5)
        with open(server_log, errors="replace") as f:
            sheds = [[kind, int(t), 1 + int(sib)]
                     for kind, t, sib in SHED_LINE.findall(f.read())]
        out["qos"] = {"warm_up": warm, "weights": weights, "elephant": el,
                      "admission": adm, "overload": overload,
                      "shed_lines": sheds,
                      "scheduler_counts": scheduler_counts(server_log),
                      "launches_by_miner": {
                          os.path.basename(m): path_launches([m])
                          for m in miners}}
        out["adapt"]["qos"] = adapt_state(server_log)
    out["launches"] = sum_launches({**{m: path_launches([m])
                                       for m in first_miners},
                                    **{m: path_launches([m])
                                       for m in miners}})
    return out


def check_sched(run: dict, default: dict, mice: dict, dev,
                counted: bool = True, answers: dict | None = None) -> None:
    """The sched path's checks. R3 striped (``chunks_striped`` > 0), the
    same answer as the default path's; R3 again from the cache with no
    launch on either miner; the warm message striped, held to the claim
    check and a direct search at 37 blocks; R4 equal to the default
    path's, released early when its hit lies in the lower half. Sheds at
    admission and under overload, the victims in the warning lines
    adding up to ``qos_shed``, exactly their tenants' clients
    disconnected; every answered mouse equal to the plain scan, the
    elephant to the mice path's, the weights' elephants to the claim
    check and a direct search, the weight-3 one finished first. The
    adapt-on run (``counted`` off) is held to every answer (the warm
    message's and the weights' to the adapt-off run ``answers``) and its
    controllers to their floors and ceilings, not to the striped chunk
    counts or the weights' finishing order, which the adapt plane's
    chunk seconds move."""
    from distributed_bitcoinminer_tpu_torch.bitcoin.hash import hash_op
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
    st = run["striping"]
    r3, again, warm, r4 = st["requests"]
    striped = st["chunks_striped_after_each"]
    for r in (r3, again, r4):
        want = default[r["request"].replace(" again", "")]
        if (r["hash"], r["nonce"]) != (want["hash"], want["nonce"]):
            fail(f"sched path {r['request']}: {r['hash'], r['nonce']} != "
                 f"the default path's {want['hash'], want['nonce']}")
    if not counted:
        for where, state in run["adapt"].items():
            check_adapt_bounds(f"{run['tag']} {where}", state)
    if counted and (not striped[0] > 0 or not striped[2] > striped[1]) \
            or not st["hint_joined_logged"]:
        fail(f"sched path: chunks_striped {striped}, hint joined "
             f"{st['hint_joined_logged']}")
    before, after = st["launches_before_each"][1:3]
    if before != after or not st["cache_replay_logged"] \
            or st["scheduler_counts"].get("cache_hits", 0) < 1:
        fail(f"sched path: R3 again launched {before} -> {after}, cache "
             f"replay logged {st['cache_replay_logged']}")
    if answers is None:
        want = NonceSearcher(warm["data"], device=dev, grid=37).search(
            0, warm["max_nonce"] + 1)
    else:
        other = answers["striping"]["requests"][2]
        want = (other["hash"], other["nonce"])
    if hash_op(warm["data"], warm["nonce"]) != warm["hash"] \
            or (warm["hash"], warm["nonce"]) != want:
        fail(f"sched path warm: {warm['hash'], warm['nonce']} != direct "
             f"{want}")
    if default["R4"]["chunk"] == 0 and not st["prefix_release_logged"]:
        fail("sched path: R4 hit in the lower half but no prefix release")
    for name, counts in st["launches_by_miner"].items():
        if not (counts["K1"] and counts["K6"]):
            fail(f"sched path: {name} launched {counts}")
    q = run["qos"]
    kinds = {k for k, _, _ in q["shed_lines"]}
    victims = sum(n for _, _, n in q["shed_lines"])
    if kinds != {"admission", "overload"} \
            or victims != q["scheduler_counts"].get("qos_shed"):
        fail(f"sched path: sheds {q['shed_lines']} against qos_shed "
             f"{q['scheduler_counts'].get('qos_shed')}")
    shed_conns = {t for _, t, _ in q["shed_lines"]}
    clients = [q["admission"], *q["overload"]]
    if SCHED_ADMISSION_CONN not in shed_conns:
        fail(f"sched path: the admission tenant was not shed: "
             f"{q['shed_lines']}")
    plain = {}
    for cl in clients:
        if cl["disconnected"] != (cl["conn"] in shed_conns):
            fail(f"sched path: conn {cl['conn']} disconnected "
                 f"{cl['disconnected']}, shed {cl['conn'] in shed_conns}")
        for (data, mx), (h, n, _) in zip(cl["requests"], cl["results"]):
            if (data, mx) not in plain:
                plain[data, mx] = plain_search(
                    NonceSearcher(data, device=dev), 0, mx + 1)
            if (h, n) != plain[data, mx]:
                fail(f"sched path mouse {data!r}: {(h, n)} != plain "
                     f"{plain[data, mx]}")
    el, want_el = q["elephant"], mice["elephant"]
    if el["disconnected"] or [el["results"][0][:2]] != \
            [[want_el["hash"], want_el["nonce"]]]:
        fail(f"sched path elephant: {el} != the mice path's {want_el}")
    done = {}
    for w in q["weights"]:
        (data, mx), = w["requests"]
        if w["disconnected"]:
            fail(f"sched path: weight tenant {w['conn']} disconnected")
        h, n, secs = w["results"][0]
        if answers is None:
            want = NonceSearcher(data, device=dev, grid=37).search(0, mx + 1)
        else:
            want = tuple(next(o["results"][0][:2]
                              for o in answers["qos"]["weights"]
                              if o["conn"] == w["conn"]))
        if hash_op(data, n) != h or (h, n) != want:
            fail(f"sched path weights {data!r}: {(h, n)} != direct {want}")
        done[w["conn"]] = secs
    if counted and not done[SCHED_WEIGHT_HEAVY] < done[SCHED_WEIGHT_LIGHT]:
        fail(f"sched path: the weight-3 elephant finished at "
             f"{done[SCHED_WEIGHT_HEAVY]:.3f} s, the weight-1 one at "
             f"{done[SCHED_WEIGHT_LIGHT]:.3f} s")


# ---------------------------------------------------------- harness phases

#: The chaos path: three ``ChaosMiner`` handles on card 0 in a worker process
#: of its own (``--chaos-storm SEED``), one of them lying in ``wrong_hash``
#: mode while the schedule's turn-coat episodes hold.
CHAOS_SEED = 11
CHAOS_MINERS = ("alpha", "beta", "gamma")
CHAOS_LIES = {"beta": "wrong_hash"}
CHAOS_DURATION_S = 8.0
CHAOS_NEW = ("chaos storm", (1 << 32) - 1)
#: Rounds of the four requests at most while the storm runs.
CHAOS_ROUNDS = 12
CHAOS_LINE = "chaos storm result "


def chaos_requests() -> list:
    """R1, R3, R4 and the new message, as ``(name, data, max_nonce,
    target)``."""
    by = {r[0]: r for r in ARGMIN_REQUESTS}
    return [("R1", *by["R1"][1:], 0), ("R3", *by["R3"][1:], 0),
            UNTIL_REQUESTS[0], ("new", *CHAOS_NEW, 0)]


def chaos_schedule(seed: int) -> list:
    from distributed_bitcoinminer_tpu_torch.lspnet import chaos
    return chaos.generate_schedule(seed, CHAOS_DURATION_S,
                                   list(CHAOS_MINERS), episodes=6,
                                   max_percent=25, kinds=chaos.BYZ_EPISODES)


def chaos_storm(seed_arg: str) -> int:
    """``--chaos-storm SEED``: the port's ``Scheduler`` on a localhost LSP
    server (2 s lease grace and floor, a 0.1 s sweep, quarantine after 3
    blown leases, every arg-min chunk audited over at most 2^20 nonces,
    no result cache) and the three ``ChaosMiner`` handles of ``CHAOS_MINERS`` on
    card 0 (the kernels warmed up first, the launch counters then at 0);
    ``seed_packet_faults(SEED)``, then the seeded schedule applied by
    ``run_schedule`` while a client submits ``chaos_requests()`` through
    ``submit_with_retry``, round after round until the storm has ended
    (``CHAOS_ROUNDS`` at most); then the pool's convergence. Its last line
    is ``CHAOS_LINE`` and a JSON object: the schedule, every answer with
    its seconds and its attempts, Results and ok outcomes, the
    scheduler's counters, the restarts and the launches. The fault knobs
    are global to a process, so the storm runs in one of its own."""
    import asyncio
    import logging
    sys.path.insert(0, ROOT)
    from distributed_bitcoinminer_tpu_torch.apps.client import \
        submit_with_retry
    from distributed_bitcoinminer_tpu_torch.apps.miner import warm_up
    from distributed_bitcoinminer_tpu_torch.apps.scheduler import Scheduler
    from distributed_bitcoinminer_tpu_torch.lsp.params import Params
    from distributed_bitcoinminer_tpu_torch.lsp.server import \
        new_async_server
    from distributed_bitcoinminer_tpu_torch.lspnet import chaos
    from distributed_bitcoinminer_tpu_torch.ops import sha256_cuda
    from distributed_bitcoinminer_tpu_torch.utils.config import (
        CacheParams, LeaseParams, RetryParams, VerifyParams)
    from distributed_bitcoinminer_tpu_torch.utils.metrics import registry
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    seed = int(seed_arg)
    warm_up("cuda")
    # Eight epochs of 0.2 s before a conn is lost: under 25% packet drop a
    # live conn survives, a killed miner is seen in 1.6 s.
    params = Params(epoch_limit=8, epoch_millis=200, window_size=5,
                    max_backoff_interval=2)
    retry = RetryParams(attempts=12, timeout_s=60.0, backoff_s=0.1,
                        backoff_cap_s=0.5)
    schedule = chaos_schedule(seed)
    same = schedule == chaos_schedule(seed)

    def counter(key: str) -> int:
        return int(registry().snapshot()["counters"].get(key, 0))

    async def storm() -> dict:
        chaos.seed_packet_faults(seed)
        server = await new_async_server(0, params)
        sched = Scheduler(
            server, lease=LeaseParams(grace_s=2.0, floor_s=2.0, tick_s=0.1,
                                      quarantine_after=3),
            verify=VerifyParams(enabled=True, audit_p=1.0,
                                audit_max_nonces=1 << 20),
            cache=CacheParams(enabled=False))
        loop = asyncio.get_running_loop()
        sched_task = loop.create_task(sched.run())
        hostport = f"127.0.0.1:{server.port}"
        miners = {}
        try:
            for name in CHAOS_MINERS:
                m = chaos.ChaosMiner(hostport, params=params, name=name,
                                     byzantine=CHAOS_LIES.get(name, ""))
                await m.start()
                miners[name] = m
                deadline = loop.time() + 60
                while sched.miner_plane.find_miner(m.conn_id) is None:
                    if loop.time() > deadline:
                        raise RuntimeError(f"{name} never joined")
                    await asyncio.sleep(0.01)
            storm_task = loop.create_task(chaos.run_schedule(schedule,
                                                             miners))
            t_storm = time.monotonic()
            answers = []
            try:
                for rnd in range(CHAOS_ROUNDS):
                    if rnd and storm_task.done():
                        break
                    for name, data, max_nonce, target in chaos_requests():
                        sent0 = sched.stats["results_sent"]
                        att0 = counter("client.retry_attempts")
                        ok0 = counter("client.retry_outcomes{outcome=ok}")
                        t0 = time.monotonic()
                        got = await asyncio.wait_for(submit_with_retry(
                            hostport, data, max_nonce, target, params,
                            retry), 600)
                        answers.append({
                            "round": rnd, "request": name, "data": data,
                            "max_nonce": max_nonce, "target": target,
                            "answer": None if got is None else list(got),
                            "seconds": time.monotonic() - t0,
                            "at_s": t0 - t_storm,
                            "attempts": counter("client.retry_attempts")
                            - att0,
                            "ok": counter("client.retry_outcomes{outcome=ok}")
                            - ok0,
                            "results_sent": sched.stats["results_sent"]
                            - sent0})
            finally:
                applied = await asyncio.wait_for(storm_task, 120)
            storm_s = time.monotonic() - t_storm
            deadline = loop.time() + 60
            converged = False
            while loop.time() < deadline:
                if (sched.current is None
                        and not sched.tenant_plane.requests()
                        and not sched.miner_plane.parked and sched.miners
                        and all(m.available for m in sched.miners)):
                    converged = True
                    break
                await asyncio.sleep(0.02)
            return {"seed": seed, "schedule": [
                        [e.at, e.action, e.subject, e.value]
                        for e in schedule],
                    "schedule_repeats": same, "applied": applied,
                    "storm_s": storm_s, "answers": answers,
                    "converged": converged, "pool": len(sched.miners),
                    "queued": len(sched.tenant_plane.requests()),
                    "parked": len(sched.miner_plane.parked),
                    "stats": sched.stats,
                    "restarts": {n: m.restarts for n, m in miners.items()},
                    "launches": dict(sha256_cuda.launches)}
        finally:
            for m in miners.values():
                await m.close()
            sched_task.cancel()
            await server.close()

    out = asyncio.run(storm())
    print(CHAOS_LINE + json.dumps(out), flush=True)
    return 0


def harness_env() -> dict:
    return dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                + os.environ.get("PYTHONPATH", ""),
                DBMT_METRICS_INTERVAL_S="0")


def run_chaos(outdir: str) -> dict:
    """The chaos path: ``--chaos-storm CHAOS_SEED`` as a subprocess,
    logging to ``chaos_storm.log``; returns its result line."""
    log = os.path.join(outdir, "chaos_storm.log")
    with open(log, "w") as fh:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--chaos-storm",
             str(CHAOS_SEED)], stdout=fh, stderr=subprocess.STDOUT,
            env=harness_env(), cwd=outdir, timeout=900)
    with open(log, errors="replace") as f:
        lines = [ln for ln in f if ln.startswith(CHAOS_LINE)]
    if proc.returncode != 0 or not lines:
        fail(f"chaos path: rc {proc.returncode}, no result line (see {log})")
    return json.loads(lines[-1][len(CHAOS_LINE):])


def check_chaos(run: dict, default: dict, dev) -> dict:
    """Every answer equal to the default path's (R1, R3, R4) or to a
    direct search on card 0 and the claim check (the new message), each
    request answered once; the schedule repeatable, the pool converged,
    and K1, K2 and K6 launched by the storm's miners."""
    from distributed_bitcoinminer_tpu_torch.bitcoin.hash import hash_op
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
    if not run["schedule_repeats"]:
        fail("chaos path: a second generation gave another schedule")
    if run["applied"] != len(run["schedule"]):
        fail(f"chaos path: {run['applied']} of {len(run['schedule'])} "
             f"events applied")
    data, max_nonce = CHAOS_NEW
    new = NonceSearcher(data, device=dev).search(0, max_nonce + 1)
    if hash_op(data, new[1]) != new[0]:
        fail(f"chaos path: the direct search's {new} fails the claim check")
    for a in run["answers"]:
        got = a["answer"]
        want = new if a["request"] == "new" else (
            default[a["request"]]["hash"], default[a["request"]]["nonce"])
        if got is None or tuple(got[:2]) != tuple(want):
            fail(f"chaos path {a['request']} round {a['round']}: {got} != "
                 f"{want}")
        if hash_op(a["data"], got[1]) != got[0]:
            fail(f"chaos path {a['request']}: claim check failed: {got}")
        # One Result reached the caller. The scheduler wrote exactly one
        # for a request answered at its first attempt, and one for each
        # attempt at most where the client retried (an abandoned
        # attempt's conn may get one before its loss is seen).
        if a["ok"] != 1 or not 1 <= a["results_sent"] <= a["attempts"] \
                or a["attempts"] == 1 and a["results_sent"] != 1:
            fail(f"chaos path {a['request']}: {a['ok']} answers, "
                 f"{a['results_sent']} Results for {a['attempts']} "
                 f"attempts")
    if not run["converged"]:
        fail(f"chaos path: the pool did not converge: {run['pool']} miners,"
             f" {run['queued']} queued, {run['parked']} parked")
    launches = {k: run["launches"].get(k, 0) for k in KERNELS}
    for k in ("K1", "K2", "K6"):
        if launches[k] <= 0:
            fail(f"chaos path: the storm's miners launched no {k}: "
                 f"{launches}")
    s = run["stats"]
    counters = {k: s[k] for k in ("leases_blown", "reissues", "quarantines",
                                  "audits_issued", "audits_failed",
                                  "claims_checked", "claims_failed",
                                  "results_sent")}
    counters["restarts"] = sum(run["restarts"].values())
    retried = [a for a in run["answers"] if a["attempts"] > 1]
    counters["requests_retried"] = len(retried)
    counters["results_beyond_one"] = sum(a["results_sent"] - 1
                                         for a in retried)
    return {"launches": launches, "counters": counters, "direct_new": new}


#: The process storm: one episode of each kind, each request 2^33-2^34
#: nonces, so that it is in flight on the card when the fault lands.
PROC_STORM_SEED = 14
PROC_STORM_RANGE = (1 << 33, 1 << 34)


def launch_totals(doc: dict) -> dict:
    """Every process's launches summed, from ``proc_launches``."""
    by_proc = proc_launches(doc)
    return {k: sum(p.get(k, 0) for p in by_proc.values()) for k in KERNELS}


def run_proc_storm(outdir: str, dev) -> dict:
    """The process-storm path: a ``ProcCluster`` (router, 2 replicas, 2
    miner agents on card 0 started one after the other, so one joins each
    replica; a 0.2 s beat) and one ``ProcEpisode`` of each
    ``PROC_EPISODES`` kind through ``run_proc_episode``, its oracle a
    direct search on card 0; between episodes the cluster heals to 2
    replicas and 2 agents. Each episode's launches are the agents' rollup
    gauges after it less before it."""
    import asyncio

    from distributed_bitcoinminer_tpu_torch.apps import procs
    from distributed_bitcoinminer_tpu_torch.lsp.params import Params
    from distributed_bitcoinminer_tpu_torch.lspnet.chaos import (
        PROC_EPISODES, generate_proc_storm, run_proc_episode)
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
    from distributed_bitcoinminer_tpu_torch.utils.config import RetryParams
    from distributed_bitcoinminer_tpu_torch.utils.metrics import registry
    params = Params(epoch_limit=10, epoch_millis=200)
    retry = RetryParams(attempts=12, timeout_s=0, backoff_s=0.2,
                        backoff_cap_s=1.0)

    def oracle(data, lower, upper):
        return NonceSearcher(data, device=dev).search(lower, upper)

    def ok_count() -> int:
        return int(registry().snapshot()["counters"].get(
            "client.retry_outcomes{outcome=ok}", 0))

    episodes = [generate_proc_storm(PROC_STORM_SEED + i, 1, kinds=(kind,),
                                    nonce_range=PROC_STORM_RANGE)[0]
                for i, kind in enumerate(PROC_EPISODES)]
    statedir = os.path.join(outdir, "proc_storm_state")
    logdir = os.path.join(outdir, "proc_storm_logs")
    for d in (statedir, logdir):
        shutil.rmtree(d, ignore_errors=True)
    c = procs.ProcCluster(statedir, replicas=2, miners=0, logdir=logdir)
    c.env.pop("DBMT_COMPUTE", None)
    c.env.update(PROCS_ENV, PYTHONPATH=ROOT + os.pathsep
                 + os.environ.get("PYTHONPATH", ""))
    records = []
    t0 = time.monotonic()
    try:
        c.start()
        for i in range(2):
            c.spawn_miner(i)
            asyncio.run(c.wait_live(2, timeout_s=300, miners=i + 1))
        c.m = 2
        start_s = time.monotonic() - t0
        for ep in episodes:
            time.sleep(0.5)                 # a fresh blob of each agent
            before = launch_totals(dbmtop_doc(statedir))
            ok0 = ok_count()
            try:
                rec = asyncio.run(asyncio.wait_for(run_proc_episode(
                    c, ep, params, retry, reply_timeout_s=300,
                    oracle=oracle), 600))
            except AssertionError as exc:
                fail(f"proc storm {ep.kind}: {exc}")
            asyncio.run(c.wait_live(2, timeout_s=300, miners=2))
            time.sleep(0.5)
            after = launch_totals(dbmtop_doc(statedir))
            rec.update(max_nonce=ep.max_nonce, tenant=ep.tenant,
                       fault_at=ep.fault_at, replies=ok_count() - ok0,
                       launches={k: after[k] - before[k] for k in KERNELS})
            records.append(rec)
    finally:
        c.close()
    return {"start_s": start_s, "episodes": records}


def check_proc_storm(run: dict) -> dict:
    """One reply an episode (equal to the card's direct search:
    ``run_proc_episode`` checked it), a fence where a replica was the
    victim, and launches in the agents."""
    from distributed_bitcoinminer_tpu_torch.apps.procs import FENCED_EXIT
    for rec in run["episodes"]:
        if rec["replies"] != 1:
            fail(f"proc storm {rec['kind']}: {rec['replies']} replies")
        if rec["kind"] != "kill_router" and rec["fence_s"] is None:
            fail(f"proc storm {rec['kind']}: replica never fenced")
        if rec["kind"] == "stop_replica" \
                and rec["fenced_exit"] != FENCED_EXIT:
            fail(f"proc storm stop_replica: the woken replica exited "
                 f"{rec['fenced_exit']}, not {FENCED_EXIT}")
    total = {k: sum(r["launches"][k] for r in run["episodes"])
             for k in KERNELS}
    if total["K1"] <= 0 or total["K6"] <= 0:
        fail(f"proc storm: the agents launched no K1 or K6: {total}")
    return total


def run_replay_phase(capture_path: str) -> dict:
    """The adapt-on mice run's capture re-sent through ``run_replay``
    (detnet, miners modelled from the capture) and ``run_replay_procs``
    (the process tier, 2 replicas and 4 instant agents): each sends the
    plan's requests, completed plus shed equal to them; the fidelity
    verdict (its ratios, ``within`` under the JAX package's rules: a
    capture over real LSP has its p99 reported, not gated) is printed."""
    from distributed_bitcoinminer_tpu_torch.apps import loadharness as lh
    from distributed_bitcoinminer_tpu_torch.apps.capture import (
        load_capture, replay_plan)
    planned = sum(len(p["reqs"]) for p in replay_plan(
        load_capture(capture_path)))
    out = {"planned": planned}
    for leg, fn in (("detnet", lambda: lh.run_replay(capture_path,
                                                      timeout_s=300)),
                    ("procs", lambda: lh.run_replay_procs(
                        capture_path, timeout_s=300))):
        t0 = time.monotonic()
        r = fn()
        r["seconds"] = time.monotonic() - t0
        if r["requests"] != planned or r.get("timed_out") \
                or r["completed"] + r["shed_requests"] != planned:
            fail(f"replay {leg}: {r['completed']} completed + "
                 f"{r['shed_requests']} shed of {r['requests']}, the plan "
                 f"{planned}")
        # The verdict is reported, not a gate: the replay's instant
        # miners end the arrivals' makespan sooner than the card ended
        # the capture's, which moves admitted/s by the workload's shape.
        out[leg] = r
    return out


def load_summary(leg: dict) -> dict:
    shed = leg.get("shed_requests", leg["shed_tenants"])
    if leg.get("timed_out") or leg["completed"] + shed != leg["requests"]:
        fail(f"load leg {leg}: {leg['completed']} completed + {shed} shed "
             f"!= {leg['requests']}")
    return {k: leg.get(k) for k in (
        "tenants", "replicas", "miners", "workload", "adapt", "requests",
        "completed", "shed_tenants", "shed_requests", "makespan_s",
        "admitted_per_s", "p50_s", "p99_s", "cpu_s_per_request")}


def run_load_phase() -> dict:
    """The load harness on the card's host: ``run_load`` with 1,000
    tenants on 1 and 4 replicas, ``mice_stampede`` with the adapt plane
    off and on, and ``run_load_procs`` with 200 tenants, 2 replicas and 4
    instant agents. Every request not shed completes."""
    from distributed_bitcoinminer_tpu_torch.apps import loadharness as lh
    legs = {}
    for name, fn in (
            ("r1", lambda: lh.run_load(tenants=1000, replicas=1)),
            ("r4", lambda: lh.run_load(tenants=1000, replicas=4)),
            ("stampede_static",
             lambda: lh.run_adversarial("mice_stampede", adapt=False)),
            ("stampede_adapt",
             lambda: lh.run_adversarial("mice_stampede", adapt=True)),
            ("procs", lambda: lh.run_load_procs(tenants=200, replicas=2,
                                                miners=4))):
        t0 = time.monotonic()
        legs[name] = load_summary(fn())
        legs[name]["seconds"] = time.monotonic() - t0
    return legs


#: The transport phase: 2 rounds of 2 s legs, fast and stock.
TRANSPORT_ENV = {"DBMT_BENCH_TRANSPORT_ROUNDS": "2",
                 "DBMT_BENCH_TRANSPORT_SECS": "2"}


def run_transport_phase() -> dict:
    """``transport_probe`` (its legs in child processes) and
    ``conn_memory_probe`` at 10,000 conns."""
    from distributed_bitcoinminer_tpu_torch.apps.transportbench import \
        transport_probe
    saved = {k: os.environ.get(k) for k in TRANSPORT_ENV}
    os.environ.update(TRANSPORT_ENV)
    try:
        probe = transport_probe(ROOT, conn_counts=(10_000,))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    es = probe["echo_storm"]
    if not es["throughput"] or not es["stock_msgs_per_s"]:
        fail(f"transport phase: no echo throughput: {es}")
    return probe


def phase_harness(outdir: str, e2e: dict) -> dict:
    """The harness paths, each its own JSON line with its seconds: the
    chaos storm, the process storm, the capture's replays, the load
    harness and the transport bench. The storms' launches join the e2e
    launches (the ``kernels`` line's counts)."""
    import torch
    dev = torch.device("cuda", 0)
    default = {r["request"]: r for r in e2e["requests"]}
    out = {}
    t0 = time.monotonic()
    chaos = run_chaos(outdir)
    summary = check_chaos(chaos, default, dev)
    emit("chaos", seconds=time.monotonic() - t0, **summary,
         schedule=chaos["schedule"], storm_s=chaos["storm_s"],
         restarts=chaos["restarts"],
         answers=[{k: a[k] for k in ("round", "request", "seconds",
                                     "attempts", "results_sent")}
                  for a in chaos["answers"]])
    e2e["launches"]["chaos"] = summary["launches"]
    out["chaos"] = summary
    t0 = time.monotonic()
    storm = run_proc_storm(outdir, dev)
    storm_launches = check_proc_storm(storm)
    emit("proc_storm", seconds=time.monotonic() - t0,
         start_s=storm["start_s"], launches=storm_launches,
         episodes=storm["episodes"])
    e2e["launches"]["proc_storm"] = storm_launches
    out["proc_storm"] = storm
    t0 = time.monotonic()
    capture = os.path.join(os.path.dirname(
        e2e["mice_adapt"][0]["server_log"]), "capture.jsonl")
    replay = run_replay_phase(capture)
    emit("replay", seconds=time.monotonic() - t0, planned=replay["planned"],
         **{leg: {k: replay[leg].get(k) for k in (
             "requests", "completed", "shed_requests", "admitted_per_s",
             "p50_s", "p99_s", "makespan_s", "seconds", "fidelity")}
            for leg in ("detnet", "procs")})
    out["replay"] = replay
    t0 = time.monotonic()
    load = run_load_phase()
    emit("load", seconds=time.monotonic() - t0, **load)
    out["load"] = load
    t0 = time.monotonic()
    transport = run_transport_phase()
    emit("transport", seconds=time.monotonic() - t0,
         **{k: transport[k] for k in ("echo_storm", "fast", "stock",
                                      "conn_memory", "mmsg_available")})
    out["transport"] = transport
    return out


#: The analysis phase: the explorer over the whole catalogue at a small
#: budget, then the miner-pipeline scenarios with a card searcher.
ANALYSIS_SEEDS = 10
ANALYSIS_DFS = 8
ANALYSIS_CARD_SEEDS = 8
ANALYSIS_CARD_LINE = "analysis card result "
SCENARIO_LINE = re.compile(r"^(\w+)\s+explored=\s*(\d+) distinct=\s*(\d+) "
                           r"violations=\s*(\d+)")


def card_scenarios(device) -> dict:
    """The explorer's two miner-pipeline scenarios (``pipelined_dispatch``,
    ``batched_dispatch``) with their fake searcher swapped for
    ``CardSearcher``: it wraps ``NonceSearcher(data, device=device)``,
    charges the virtual clock exactly as the fake does (the same draws
    from the same stream, so a seed gives the fake's schedule) and answers
    from the searcher: on ``cuda`` its ``dispatch`` starts the K1 launches
    chained through K6 and returns before they end, ``finalize`` forces
    the carry, and ``dispatch_batch`` is K5. The scenarios' own checks
    hold every Result to the oracle. ``CardSearcher.answers`` counts the
    answers it gave, ``CardSearcher.batches`` its batched dispatches."""
    from distributed_bitcoinminer_tpu_torch.analysis.schedcheck import (
        scenarios)
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher

    class CardSearcher(scenarios._FakeSearcher):
        answers = batches = 0

        def __init__(self, data, ctx, rng, rate: float = 4000.0):
            super().__init__(data, ctx, rng, rate)
            self.inner = NonceSearcher(data, device=device)

        def _answered(self, n: int = 1) -> None:
            type(self).answers += n

        def search(self, lower: int, upper: int):
            self._charge(upper - lower + 1)
            self._answered()
            return self.inner.search(lower, upper)

        def search_until(self, lower: int, upper: int, target: int):
            self._charge(upper - lower + 1)
            self._answered()
            return self.inner.search_until(lower, upper, target)

        def dispatch(self, lower: int, upper: int):
            self._charge(upper - lower + 1, frac=0.2)
            return lower, upper, self.inner.dispatch(lower, upper)

        def finalize(self, handle, lower: int):
            lo, up, carry = handle
            self._charge(up - lo + 1, frac=0.8)
            self._answered()
            return self.inner.finalize(carry, lower)

        def dispatch_batch(self, entries):
            for _s, lo, up in entries:
                if lo > up:
                    raise ValueError("empty range")
            sizes = [up - lo + 1 for _s, lo, up in entries]
            self._charge(sum(sizes), frac=0.2)
            type(self).batches += 1
            handle = self.inner.dispatch_batch(
                [(s.inner, lo, up) for s, lo, up in entries])
            if handle is None:
                raise RuntimeError("the card searchers could not share a "
                                   "batched launch")
            return sizes, handle

        def finalize_batch(self, handle):
            sizes, inner = handle
            self._charge(sum(sizes), frac=0.8)
            self._answered(len(sizes))
            return self.inner.finalize_batch(inner)

    class CardPipelined(scenarios.PipelinedDispatch):
        SEARCHER = CardSearcher

    class CardBatched(scenarios.BatchedDispatch):
        SEARCHER = CardSearcher

    return {"searcher": CardSearcher,
            "pipelined_dispatch": CardPipelined,
            "batched_dispatch": CardBatched}


def run_card_scenarios(device, seeds: int) -> dict:
    """``seeds`` schedules of each card scenario, each beside the fake's
    schedule of the same seed: the violations (each with its repro spec),
    the distinct schedules, how many equal the fake's step for step, the
    card's answers and batched dispatches."""
    from distributed_bitcoinminer_tpu_torch.analysis.schedcheck import (
        ALL, execute, format_spec)
    card = card_scenarios(device)

    def steps(result) -> list:
        # An executor step names its function's class (the fake's or the
        # card's searcher): compare by method name.
        return [st.rsplit(".", 1)[-1] if st.startswith("executor:") else st
                for st in result.steps]
    out = {"schedules": 0, "violations": [], "same_as_fake": 0}
    distinct = set()
    for name in ("pipelined_dispatch", "batched_dispatch"):
        for seed in range(seeds):
            fake = execute(ALL[name](), seed)
            got = execute(card[name](), seed)
            out["schedules"] += 1
            distinct.add((name, got.schedule_key()))
            out["same_as_fake"] += steps(got) == steps(fake)
            if got.failed:
                out["violations"].append(
                    f"{format_spec(got)}: {got.violations}")
    out["distinct"] = len(distinct)
    out["answers"] = card["searcher"].answers
    out["batches"] = card["searcher"].batches
    return out


def analysis_card() -> int:
    """The worker of the analysis phase's card half (``--analysis-card``):
    the card scenarios on card 0 in a process of its own (the explorer
    patches ``time.monotonic`` and arms the sanitizer), its launches
    counted from 0; one result line."""
    os.environ["DBMT_METRICS_INTERVAL_S"] = "0"
    os.environ.setdefault("DBMT_SANITIZE", "1")
    sys.path.insert(0, ROOT)
    import torch
    from distributed_bitcoinminer_tpu_torch.ops import sha256_cuda
    if not torch.cuda.is_available():
        print("chip_smoke --analysis-card: no CUDA device", file=sys.stderr)
        return 1
    sha256_cuda.reset_launches()
    out = run_card_scenarios(torch.device("cuda", 0), ANALYSIS_CARD_SEEDS)
    out["launches"] = {k: sha256_cuda.launches[k] for k in KERNELS}
    print(ANALYSIS_CARD_LINE + json.dumps(out), flush=True)
    return 1 if out["violations"] \
        or out["same_as_fake"] != out["schedules"] else 0


def phase_analysis(outdir: str, e2e: dict) -> dict:
    """The analysis tier on the card's host, its three parts started
    together: ``tools/dbmlint.py --list`` on this tree (exit 0, no
    finding), ``tools/dbmcheck.py`` over the whole catalogue at
    ``--seeds ANALYSIS_SEEDS --dfs ANALYSIS_DFS`` (exit 0, no violation),
    and the card scenarios in a worker (``--analysis-card``): each Result
    held to the oracle by the scenarios' checks, and K1, K5 and K6 each
    launched. Its launches join the e2e launches (the ``kernels``
    line's)."""
    t0 = time.monotonic()
    env = harness_env()
    parts = {
        "lint": [sys.executable, "-m", f"{PKG}.tools.dbmlint", "--list"],
        "check": [sys.executable, "-m", f"{PKG}.tools.dbmcheck",
                  "--seeds", str(ANALYSIS_SEEDS), "--dfs", str(ANALYSIS_DFS),
                  "--budget-s", "600"],
        "card": [sys.executable, os.path.abspath(__file__),
                 "--analysis-card"]}
    procs, logs, rcs, text = {}, {}, {}, {}
    try:
        for name, cmd in parts.items():
            logs[name] = os.path.join(outdir, f"analysis_{name}.log")
            with open(logs[name], "w") as out, \
                    open(logs[name] + ".err", "w") as err:
                procs[name] = subprocess.Popen(cmd, stdout=out, stderr=err,
                                               env=env, cwd=ROOT)
        for name, proc in procs.items():
            rcs[name] = proc.wait(timeout=600)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name in parts:
        with open(logs[name], errors="replace") as f:
            text[name] = f.read()
    findings = [ln for ln in text["lint"].splitlines()
                if ln.startswith(("NEW ", "base "))]
    if rcs["lint"] != 0 or findings:
        fail(f"dbmlint: rc {rcs['lint']}, findings {findings} "
             f"(see {logs['lint']})")
    scen = {m.group(1): {"explored": int(m.group(2)),
                         "distinct": int(m.group(3)),
                         "violations": int(m.group(4))}
            for m in map(SCENARIO_LINE.match, text["check"].splitlines())
            if m}
    if rcs["check"] != 0 or "DBMCHECK_RC=0" not in text["check"] \
            or len(scen) != 17 \
            or any(s["violations"] or s["explored"] < ANALYSIS_SEEDS
                   for s in scen.values()):
        fail(f"dbmcheck: rc {rcs['check']}, scenarios {scen} "
             f"(see {logs['check']})")
    lines = [ln for ln in text["card"].splitlines()
             if ln.startswith(ANALYSIS_CARD_LINE)]
    if not lines:
        fail(f"analysis card worker: rc {rcs['card']}, no result line "
             f"(see {logs['card']})")
    card = json.loads(lines[-1][len(ANALYSIS_CARD_LINE):])
    if rcs["card"] != 0 or card["violations"] \
            or card["same_as_fake"] != card["schedules"]:
        fail(f"analysis card scenarios: rc {rcs['card']}, violations "
             f"{card['violations']}, {card['same_as_fake']} of "
             f"{card['schedules']} schedules the fake's")
    for kern in ("K1", "K5", "K6"):
        if card["launches"].get(kern, 0) <= 0:
            fail(f"analysis card scenarios launched no {kern}: "
                 f"{card['launches']}")
    summary = {
        "lint_findings": len(findings),
        "explored": sum(s["explored"] for s in scen.values()),
        "distinct": sum(s["distinct"] for s in scen.values()),
        "violations": 0, "scenarios": scen,
        "card_schedules": card["schedules"],
        "card_distinct": card["distinct"],
        "card_same_as_fake": card["same_as_fake"],
        "card_answers": card["answers"],
        "card_batches": card["batches"],
        "launches": card["launches"]}
    emit("analysis", seconds=time.monotonic() - t0, **summary)
    e2e["launches"]["analysis"] = card["launches"]
    return summary


def per_block_search(searcher, lower: int, upper: int, scan):
    """The searcher's block plan, one ``scan(plan)`` (a (3,) device tensor
    ``(hi, lo, idx)``) per block, the triples copied to the host in one
    stacked fetch and merged in ascending order with a strict less (the
    earliest nonce keeps a tie; an all-ones triple had no valid lane)."""
    import torch
    plans = list(searcher.plan(lower, upper))
    fetched = torch.stack([scan(p) for p in plans]).cpu().tolist()
    best = None
    for p, triple in zip(plans, fetched):
        hi, lo, idx = (int(x) & M32 for x in triple)
        if (hi, lo, idx) != (M32, M32, M32) and (
                best is None or (hi << 32 | lo) < best[0]):
            best = (hi << 32 | lo, p.base + idx)
    return best or ((1 << 64) - 1, lower)


def plain_search(searcher, lower: int, upper: int):
    """The searcher's block plan run through the plain scan on its
    device."""
    from distributed_bitcoinminer_tpu_torch.ops.search import span_scan
    return per_block_search(searcher, lower, upper, lambda p: span_scan(
        p.midstate, p.template, p.lo_i, p.lo_i, p.hi_i, p.lanes, rem=p.rem,
        k=p.k, device=searcher.device))


def per_block_until(searcher, lower: int, upper: int, target: int, scan,
                    lookahead: int = 0):
    """Difficulty mode one block at a time: ``scan(plan, t_hi, t_lo)`` (a
    (5,) device tensor ``(found, f_idx, best_hi, best_lo, best_idx)``)
    per block, each block's words read in ascending order, with
    ``lookahead`` later blocks launched before a block's words are read
    (each copy goes to pinned memory behind an event, so a queued launch
    does not delay it); stops at the first block that hits. Returns
    (hash, nonce, found) like ``search_until``."""
    import torch
    from distributed_bitcoinminer_tpu_torch.bitcoin.hash import hash_op
    t_hi, t_lo = target >> 32, target & M32
    plans, inflight, best = iter(searcher.plan(lower, upper)), [], None
    while True:
        while len(inflight) <= lookahead:
            p = next(plans, None)
            if p is None:
                break
            out = scan(p, t_hi, t_lo)
            host = torch.empty(out.shape, dtype=out.dtype,
                               pin_memory=out.is_cuda)
            host.copy_(out, non_blocking=out.is_cuda)
            done = torch.cuda.Event() if out.is_cuda else None
            if done is not None:
                done.record()
            inflight.append((p, host, done))
        if not inflight:
            return (*best, False) if best else ((1 << 64) - 1, lower, False)
        p, host, done = inflight.pop(0)
        if done is not None:
            done.synchronize()
        found, f_idx, b_hi, b_lo, b_idx = words(host)
        if found:
            return hash_op(searcher.data, p.base + f_idx), p.base + f_idx, True
        if (b_hi, b_lo, b_idx) != (M32, M32, M32) and (
                best is None or (b_hi << 32 | b_lo) < best[0]):
            best = (b_hi << 32 | b_lo, p.base + b_idx)


def plain_search_until(searcher, lower: int, upper: int, target: int):
    """The searcher's block plan through the plain until scan on its
    device, in ascending order, stopping at the first block that hits:
    (hash, nonce, found) like ``search_until``."""
    from distributed_bitcoinminer_tpu_torch.ops.search import span_until_scan
    return per_block_until(
        searcher, lower, upper, target,
        lambda p, t_hi, t_lo: span_until_scan(
            p.midstate, p.template, p.lo_i, p.lo_i, p.hi_i, p.lanes, t_hi,
            t_lo, rem=p.rem, k=p.k, device=searcher.device))


#: Instructions of one SHA-256 round whose state differs per lane, in
#: Hopper's fused forms: S0 and S1 (3 SHF rotates and 1 LOP3 each), ch and
#: maj (1 LOP3 each), and t1, e and a (4 IADD3); the rotates and the logic,
#: 10 of them, run as SHF and LOP3 only on the INT32 pipe, and 6 of those
#: are rotates.
ROUND_OPS, ROUND_INT32_OPS, ROUND_ROTATES = 14, 10, 6
#: s0 or s1 of a schedule word: 2 SHF rotates and a LOP3 on the INT32 pipe,
#: and the shift, which either pipe takes (IMAD.HI on the FMA pipe).
SIG_OPS, SIG_INT32_OPS, SIG_ROTATES = 4, 3, 2
#: K2's per-lane target compare: hi below, hi equal and lo below, fused
#: into ISETP chains and one predicate combine.
TARGET_OPS = 3


def needed_int_ops(rem: int, k: int, nblocks: int,
                   target: bool = False) -> tuple:
    """Integer instructions that one nonce's hash needs, for k digits at
    tail byte ``rem`` of an ``nblocks``-block tail, in Hopper's fused forms
    (IADD3, LOP3, SHF, ISETP, SEL): the work of a run of ``RUN_LANES``
    aligned lanes, which share every digit but the last, over its lanes;
    with ``target``, K2's compare too. Returns ``(all, int32, rotates)``:
    every instruction; those that run as SHF or LOP3, on the INT32 pipe
    alone, the rotates and the logic of each round and of s0 and s1; and
    the rotates among them.

    Work that is the same for every lane is left out: the rounds before
    the first digit word, and the schedule words and terms that no digit
    reaches. Once a run: the digits (per digit the shift of the /10
    quotient and one byte placement; the divides' IMADs issue on the FMA
    pipe; one OR, an add of disjoint bytes, into each digit word), the
    schedule words and terms that the other digits reach and the last
    digit does not, the rounds from the first digit word up to the last
    digit's word (the first of them adds W to a constant for e and a, 2),
    and a block's feed-forward (8) when its state differs per run but not
    per lane. Once a lane: the last digit's byte (one add; it goes from
    '0' to '9' with no carry), the schedule words that the last digit's
    word reaches (s0 and s1 only where their input does, the other terms
    folded into one constant a run), the rounds from the last digit's word
    on (the first of them, on a state the run shares, adds W for e and a,
    2), the feed-forward (8 words between blocks, digest words 0 and 1 at
    the end, where round 63's e update is dead) and the key compare (2
    ISETP, 3 SEL). A run cut by the window's ends does its run work for
    fewer lanes; that is not counted, so the figure errs low.

    The counts err low. The adds, the shifts, the digits' placement, the
    compares and the selects count as work either pipe could take, though
    ISETP and SEL run on the INT32 pipe. A rotate counts as one SHF, but
    :func:`bound_floors` lets it move to the FMA pipe as the two IMADs
    (IMAD.SHL, IMAD.HI) it costs there, so the pipes' floor holds for any
    placement of the rotates, not only this source's.
    """
    from distributed_bitcoinminer_tpu_torch.ops.sha256_cuda import RUN_LANES
    digit_words = {b // 4 for b in range(rem, rem + k)}
    last_word = (rem + k - 1) // 4
    # [all, int32, rotates] once a run and once a lane
    run = [2 * k + len(digit_words), 0, 0]
    lane = [1 + 5 + TARGET_OPS * target, 0, 0]

    def add(acc, ops, int32=0, rotates=0):
        acc[0] += ops
        acc[1] += int32
        acc[2] += rotates

    def sched(acc, terms, taps):
        """A schedule word's work on the ``terms`` (w16, s0's input, w7,
        s1's input) that vary, and one constant unless every one of its
        ``taps`` varies."""
        adds = (sum(terms) + (not all(taps))) // 2
        sigmas = terms[1] + terms[3]
        add(acc, SIG_OPS * sigmas + adds, SIG_INT32_OPS * sigmas,
            SIG_ROTATES * sigmas)
    run_state = lane_state = False
    for b in range(nblocks):
        run_var = [16 * b + m in digit_words for m in range(16)]
        lane_var = [16 * b + m == last_word for m in range(16)]
        for t in range(16, 64):
            rterms = (run_var[t - 16], run_var[t - 15], run_var[t - 7],
                      run_var[t - 2])
            lterms = (lane_var[t - 16], lane_var[t - 15], lane_var[t - 7],
                      lane_var[t - 2])
            run_var.append(any(rterms))
            lane_var.append(any(lterms))
            # The taps that vary per run and not per lane, and the sum of
            # them with the constant ones (per lane: one constant left).
            sched(run, [r and not ln for r, ln in zip(rterms, lterms)],
                  rterms)
            if lane_var[t]:
                sched(lane, lterms, lterms)
        for t in range(64):
            if lane_state:
                add(lane, ROUND_OPS, ROUND_INT32_OPS, ROUND_ROTATES)
            elif lane_var[t]:
                add(lane, 2)
                if run_state:
                    add(run, ROUND_OPS, ROUND_INT32_OPS, ROUND_ROTATES)
                lane_state = True
            elif run_state:
                add(run, ROUND_OPS, ROUND_INT32_OPS, ROUND_ROTATES)
            elif run_var[t]:
                add(run, 2)
                run_state = True
        if b == nblocks - 1:
            add(lane, 2 - 1)
        elif lane_state:
            add(lane, 8)
        elif run_state:
            add(run, 8)
    return tuple(ln + r / RUN_LANES for ln, r in zip(lane, run))


def clock_ms(lanes: int, per_lane: float, dev_info: dict,
             per_clk: int) -> float:
    """Milliseconds of ``lanes`` lanes of ``per_lane`` instructions at
    ``per_clk`` lanes a clock on every SM at the card's maximum SM
    clock."""
    clk_hz = float(dev_info["clocks_max_sm_mhz"].split()[0]) * 1e6
    return lanes * per_lane / (dev_info["sms"] * per_clk * clk_hz) * 1e3


def pipes_per_lane(ops: tuple) -> float:
    """The least instructions a lane puts on the busier of the SM's two
    integer pipes (INT32 and FMA, 64 lanes a clock each), for ``ops`` =
    ``(all, int32, rotates)`` of :func:`needed_int_ops`: the SHF and LOP3
    work runs on the INT32 pipe, every other instruction on either pipe,
    and any x of the rotates on the FMA pipe instead, as two IMADs each.
    With the work balanced, both pipes carry ``(all + x) / 2``, the issue
    rate's share too; that takes x = (int32 - other) / 3 rotates, fewer
    when the INT32 work is no more than the rest, and all of them at
    most."""
    total, int32, rotates = ops
    moved = min(rotates, max(0.0, (2 * int32 - total) / 3))
    return max(int32 - moved, (total + moved) / 2)


def bound_floors(lanes: int, ops: tuple, dev_info: dict,
                 nbytes: int = 4 * 49 + 32) -> dict:
    """The least milliseconds of ``lanes`` lanes that each need ``ops`` =
    ``(all, int32, rotates)`` instructions (:func:`needed_int_ops`), three
    floors: every instruction at the SM's issue rate (128 lanes a clock,
    ``issue_ms``), the busier integer pipe at 64 with the rotates placed
    at best (:func:`pipes_per_lane`, ``pipes_ms``), and ``nbytes`` (by
    default the 196-byte plan in, at most 32 bytes out) at 3.35 TB/s.
    ``ms`` is the largest, ``by`` what sets it ("operations" or "bytes").
    ``int32_only_ms``, every SHF and LOP3 on the INT32 pipe, is not a
    floor (a rotate can leave that pipe), only this source's placement's
    cost: it is reported beside the bound."""
    issue = clock_ms(lanes, ops[0], dev_info, RATE_ISSUE_PER_CLK_PER_SM)
    pipes = clock_ms(lanes, pipes_per_lane(ops), dev_info,
                     RATE_INT32_PER_CLK_PER_SM)
    int32_only = clock_ms(lanes, ops[1], dev_info, RATE_INT32_PER_CLK_PER_SM)
    nbytes_ms = nbytes / 3.35e12 * 1e3
    ms = max(issue, pipes, nbytes_ms)
    return {"ms": ms, "by": "bytes" if ms == nbytes_ms else "operations",
            "issue_ms": issue, "pipes_ms": pipes,
            "int32_only_ms": int32_only, "bytes_ms": nbytes_ms}


def bound_ms(lanes: int, ops: tuple, dev_info: dict) -> tuple:
    """(least milliseconds, what bounds it) of :func:`bound_floors`."""
    f = bound_floors(lanes, ops, dev_info)
    return f["ms"], f["by"]


#: A 50-character message: in the 10^9 block the tail holds 52 bytes before
#: the 9 digits, so the digits end in the first tail block and the second
#: holds none.
DIGIT_FREE_DATA = "a fifty-character message; its digits stay in one."


#: The three rates blocks' tails (rem, k), which fix the shapes of the
#: SASS-reading builds: "cmu440" at 10^9, R2's message at 10^8, the
#: 50-character one at 10^9.
RATE_SHAPES = {"one_block": (8, 9), "two_block": (61, 9),
               "two_block_digit_free": (52, 9)}
#: The rates blocks: (name, message, lower, upper).
RATE_BLOCKS = (("one_block", "cmu440", 10 ** 9, 2 * 10 ** 9 - 1),
               ("two_block", R2_DATA, 10 ** 8, 10 ** 9 - 1),
               ("two_block_digit_free", DIGIT_FREE_DATA, 10 ** 9,
                2 * 10 ** 9 - 1))


def sass_alu_count(ops: dict) -> float:
    from distributed_bitcoinminer_tpu_torch.tools.tune import int32_count
    return int32_count(ops)


def rates_k1(dev_info: dict, outdir: str, dev) -> dict:
    """K1 over one full 10^9 block (1-block tail, the R3 shape), over the
    9*10^8-lane block of R2's message (2-block tail, digits in both
    blocks) and over a 10^9 block whose second tail block holds no digit,
    and the plain scan over 2^22 lanes of the first; then K3 and K4 on
    each block beside K1, each with the SASS of its lane loop for that
    block's shape (the SASS-reading builds of ``phase_build``) and the
    whole loop of its production kernel (every shape's copy)."""
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
    from distributed_bitcoinminer_tpu_torch.ops import search, sha256_cuda
    from distributed_bitcoinminer_tpu_torch.ops.sha256_torch import \
        build_hoist
    from distributed_bitcoinminer_tpu_torch.tools.tune import pipe_counts
    cases = {}
    for name, data, lower, upper in RATE_BLOCKS:
        (p,) = list(NonceSearcher(data, device=dev).plan(lower, upper))
        if (p.rem, p.k) != RATE_SHAPES[name]:
            fail(f"rates block {name} has rem {p.rem}, k {p.k}")
        args = (p.midstate, p.template, p.lo_i, p.lo_i, p.hi_i, p.lanes)
        kw = dict(rem=p.rem, k=p.k, device=dev)
        with ClockSampler() as clocks:
            ms = cuda_ms(lambda: sha256_cuda.sha256_argmin(*args, **kw), 3)
        nb = int(p.template.shape[0])
        variant = sha256_cuda.variant_of(p.rem, p.k, nb)
        per_lane, total, ops, loops = sass_loop_instructions(
            os.path.join(sha256_cuda.BUILD_DIR,
                         f"sass_probe_rolled_{name}.so"), variant, outdir,
            tag=f"_rolled_{name}")
        whole, _, _, _ = sass_loop_instructions(sha256_cuda.LIBRARY, variant,
                                                outdir)
        sass_alu = sass_alu_count(ops)
        needed = needed_int_ops(p.rem, p.k, nb)
        floors = bound_floors(p.lanes, needed, dev_info)
        cases[name] = {"data": data, "lanes": p.lanes, "rem": p.rem,
                       "k": p.k, "nblocks": nb, "variant": variant, "ms": ms,
                       "nonces_per_s": p.lanes / (ms / 1e3),
                       "needed_int_ops_per_lane": needed[0],
                       "needed_int32_ops_per_lane": needed[1],
                       "needed_rotates_per_lane": needed[2],
                       "bound_ms": floors["ms"], "bound_by": floors["by"],
                       "share_of_bound": floors["ms"] / ms,
                       "issue_floor_ms": floors["issue_ms"],
                       "pipes_floor_ms": floors["pipes_ms"],
                       "int32_only_ms": floors["int32_only_ms"],
                       "sass_loop_insns_per_lane": per_lane,
                       "sass_loops": loops,
                       "sass_alu_insns_per_lane": sass_alu,
                       "sass_pipes_per_lane": pipe_counts(ops),
                       "sass_int32_pipe_ms": clock_ms(
                           p.lanes, sass_alu, dev_info,
                           RATE_INT32_PER_CLK_PER_SM),
                       "sass_kernel_insns": total, "sass_loop_ops": ops,
                       "sass_loop_insns_all_shapes": whole,
                       "clocks_sm_power_during": clocks.samples}
        hoist = build_hoist(p.midstate, p.template, p.rem, p.k).ops
        for kern, body, hoisted in PEELED:
            pkw = {"peel": True, "hoist": hoist if hoisted else None}
            with ClockSampler() as clocks:
                pms = cuda_ms(lambda: sha256_cuda.sha256_argmin(
                    *args, **kw, **pkw), 3)
            lane, _, lane_ops, loops = sass_loop_instructions(
                os.path.join(sha256_cuda.BUILD_DIR,
                             f"sass_probe_{body}_{name}.so"), variant,
                outdir, tag=f"_{body}_{name}")
            whole, _, _, _ = sass_loop_instructions(
                sha256_cuda.LIBRARIES[body], variant, outdir,
                tag=f"_{body}")
            cases[name][kern] = {
                "ms": pms, "k1_ms": ms, "nonces_per_s": p.lanes / (pms / 1e3),
                "bound_ms": floors["ms"],
                "share_of_bound": floors["ms"] / pms,
                "variant": variant,
                "sass_loop_insns_per_lane": lane, "sass_loops": loops,
                "sass_alu_insns_per_lane": sass_alu_count(lane_ops),
                "sass_pipes_per_lane": pipe_counts(lane_ops),
                "sass_loop_ops": lane_ops,
                "sass_loop_insns_all_shapes": whole,
                "clocks_sm_power_during": clocks.samples}
        if name == "one_block":
            small = 1 << 22
            sargs = args[:4] + (small - 1, small)
            cases[name]["ms_2p22"] = cuda_ms(
                lambda: sha256_cuda.sha256_argmin(*sargs, **kw), 5)
            cases[name]["plain_ms_2p22"] = cuda_ms(
                lambda: search.span_scan(*sargs, **kw), 2)
            cases[name]["plain_nonces_per_s"] = small / (
                cases[name]["plain_ms_2p22"] / 1e3)
            for kern, body, hoisted in PEELED:
                pkw = {"peel": True, "hoist": hoist if hoisted else None}
                cases[name][kern]["ms_2p22"] = cuda_ms(
                    lambda: sha256_cuda.sha256_argmin(*sargs, **kw, **pkw), 5)
                cases[name][kern]["plain_ms_2p22"] = cuda_ms(
                    lambda: search.span_scan(*sargs, **kw,
                                             hoist=pkw["hoist"]), 2)
    return cases


def hit_block(dev):
    """A 10^9 block of "cmu440" whose first lane below the target lies in
    [10^8, 1.25 * 10^8): the target is the minimum hash of the block's
    first 10^8 lanes (K1), so no lane before 10^8 meets it, and the first
    hit after it is found with K2. Returns (plan, target, hit lane)."""
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
    from distributed_bitcoinminer_tpu_torch.ops import sha256_cuda
    s = NonceSearcher("cmu440", device=dev)
    for b in range(1, 60):
        (p,) = list(s.plan(b * 10 ** 9, b * 10 ** 9 + 10 ** 9 - 1))
        hi, lo, _ = words(sha256_cuda.sha256_argmin(
            p.midstate, p.template, 0, 0, 10 ** 8 - 1, 10 ** 8, rem=p.rem,
            k=p.k, device=dev))
        t = hi << 32 | lo
        found, f_idx = words(sha256_cuda.sha256_until(
            p.midstate, p.template, p.lo_i, p.lo_i, p.hi_i, p.lanes,
            t >> 32, t & M32, rem=p.rem, k=p.k, device=dev))[:2]
        if found and 10 ** 8 <= f_idx < 125 * 10 ** 6:
            return p, t, f_idx
    fail("no 10^9 block of cmu440 has its first hit in [1e8, 1.25e8)")


def rates_k2(dev_info: dict, outdir: str, dev, one_block: dict,
             hit: tuple) -> dict:
    """K2 with a target nothing meets over the one_block case's block
    (beside K1 there, with the SASS a nonce of its lane work for that
    shape), the plain until scan over 2^22 of its lanes, and K2 to a first
    hit a little past lane 10^8 of another 10^9 block, beside K2 and K1
    over all of that block."""
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
    from distributed_bitcoinminer_tpu_torch.ops import search, sha256_cuda
    from distributed_bitcoinminer_tpu_torch.tools.tune import pipe_counts
    (p,) = list(NonceSearcher("cmu440", device=dev).plan(
        10 ** 9, 2 * 10 ** 9 - 1))
    args = (p.midstate, p.template, p.lo_i, p.lo_i, p.hi_i, p.lanes)
    kw = dict(rem=p.rem, k=p.k, device=dev)
    nb = int(p.template.shape[0])
    needed = needed_int_ops(p.rem, p.k, nb, target=True)
    ms = cuda_ms(lambda: sha256_cuda.sha256_until(*args, 0, 0, **kw), 3)
    floors = bound_floors(p.lanes, needed, dev_info)
    b_ms, b_by = floors["ms"], floors["by"]
    small = 1 << 22
    sargs = args[:4] + (small - 1, small)
    plain_ms = cuda_ms(lambda: search.span_until_scan(*sargs, 0, 0, **kw), 2)
    per_lane, _, ops, loops = sass_loop_instructions(
        os.path.join(sha256_cuda.BUILD_DIR, "sass_probe_rolled_one_block.so"),
        0, outdir, tag="_until_rolled_one_block",
        kernel="sha256_until_kernelILi{v}ELb0E")
    info = {"lanes": p.lanes, "rem": p.rem, "k": p.k, "nblocks": nb,
            "ms": ms, "k1_ms_same_block": one_block["ms"],
            "sass_loop_insns_per_lane": per_lane, "sass_loops": loops,
            "sass_pipes_per_lane": pipe_counts(ops),
            "needed_int_ops_per_lane": needed[0],
            "needed_int32_ops_per_lane": needed[1],
            "needed_rotates_per_lane": needed[2], "bound_ms": b_ms,
            "bound_by": b_by, "share_of_bound": b_ms / ms,
            "issue_floor_ms": floors["issue_ms"],
            "pipes_floor_ms": floors["pipes_ms"],
            "int32_only_ms": floors["int32_only_ms"],
            "ms_2p22": cuda_ms(lambda: sha256_cuda.sha256_until(
                *sargs, 0, 0, **kw), 5),
            "plain_ms_2p22": plain_ms}
    hp, t, f_idx = hit
    hargs = (hp.midstate, hp.template, hp.lo_i, hp.lo_i, hp.hi_i, hp.lanes)
    hkw = dict(rem=hp.rem, k=hp.k, device=dev)
    to_hit = cuda_ms(lambda: sha256_cuda.sha256_until(
        *hargs, t >> 32, t & M32, **hkw), 5)
    miss = cuda_ms(lambda: sha256_cuda.sha256_until(*hargs, 0, 0, **hkw), 3)
    k1 = cuda_ms(lambda: sha256_cuda.sha256_argmin(*hargs, **hkw), 3)
    hit_floors = bound_floors(f_idx - hp.lo_i + 1, needed_int_ops(
        hp.rem, hp.k, int(hp.template.shape[0]), target=True), dev_info)
    info["first_hit"] = {
        "base": hp.base, "hit_lane": f_idx, "ms_to_hit": to_hit,
        "ms_no_target_same_block": miss, "k1_ms_same_block": k1,
        "share_of_no_target": to_hit / miss,
        "bound_ms_to_hit": hit_floors["ms"],
        "issue_floor_ms_to_hit": hit_floors["issue_ms"],
        "pipes_floor_ms_to_hit": hit_floors["pipes_ms"],
        "int32_only_ms_to_hit": hit_floors["int32_only_ms"]}
    if to_hit > 0.2 * miss:
        fail(f"K2 took {to_hit:.2f} ms to a hit at lane {f_idx}, above 20% "
             f"of its {miss:.2f} ms over the whole block")
    # The same until launch to that hit under the peeled bodies.
    from distributed_bitcoinminer_tpu_torch.ops.sha256_torch import \
        build_hoist
    hoist = build_hoist(hp.midstate, hp.template, hp.rem, hp.k).ops
    for kern, _, hoisted in PEELED:
        pkw = {"peel": True, "hoist": hoist if hoisted else None}
        got = words(sha256_cuda.sha256_until(*hargs, t >> 32, t & M32,
                                             **hkw, **pkw))
        if got[:2] != (1, f_idx):
            fail(f"{kern} until over the hit block: {got[:2]} != "
                 f"(1, {f_idx})")
        info["first_hit"][kern] = {
            "ms_to_hit": cuda_ms(lambda: sha256_cuda.sha256_until(
                *hargs, t >> 32, t & M32, **hkw, **pkw), 5),
            "ms_no_target_same_block": cuda_ms(
                lambda: sha256_cuda.sha256_until(*hargs, 0, 0, **hkw,
                                                 **pkw), 3)}
    return info


def k1_triple(p, dev, grid=None):
    """K1 over one block plan: its (3,) ``(hi, lo, idx)`` device tensor."""
    from distributed_bitcoinminer_tpu_torch.ops import sha256_cuda
    return sha256_cuda.sha256_argmin(p.midstate, p.template, p.lo_i, p.lo_i,
                                     p.hi_i, p.lanes, rem=p.rem, k=p.k,
                                     device=dev, grid=grid)


def k2_words(p, t_hi, t_lo, dev):
    """K2 over one block plan: its (5,) device tensor."""
    from distributed_bitcoinminer_tpu_torch.ops import sha256_cuda
    return sha256_cuda.sha256_until(p.midstate, p.template, p.lo_i, p.lo_i,
                                    p.hi_i, p.lanes, t_hi, t_lo, rem=p.rem,
                                    k=p.k, device=dev)


def rates_k6(dev_info: dict, dev, hit: tuple) -> dict:
    """K6's arg-min chain over R3's blocks and over the mouse's against
    per-block K1 launches with one stacked fetch, in turns; the plain
    scan-and-fold chain beside K6 over four 2^20-lane windows; K6's until
    chain from a fresh carry to the first hit of the ``hit`` block
    (beside K2 there) and over R4's range, whole and in two parts; and a
    chained until launch after a hit over a whole 10^9 block."""
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
    from distributed_bitcoinminer_tpu_torch.ops import (search, searchop,
                                                        sha256_cuda)
    chain = NonceSearcher("cmu440", device=dev)

    def in_turns(lower: int, upper: int, reps: int) -> dict:
        """Milliseconds of the chain and of per-block K1 with one stacked
        fetch over [lower, upper], in turns (per-block, chain, chain,
        per-block), each turn the mean of ``reps`` back-to-back runs."""
        answers, times = {}, {"per_block": [], "chain": []}
        shapes = {"chain": lambda: chain.search(lower, upper),
                  "per_block": lambda: per_block_search(
                      chain, lower, upper, lambda p: k1_triple(p, dev))}
        for name in ("per_block", "chain", "chain", "per_block"):
            times[name].append(event_ms(lambda: [
                answers.__setitem__(name, shapes[name]())
                for _ in range(reps)]) / reps)
        if answers["chain"] != answers["per_block"]:
            fail(f"K6 chain {answers['chain']} != per-block K1 "
                 f"{answers['per_block']} over [{lower}, {upper}]")
        return times

    lower, upper = 0, 1 << 32
    times = in_turns(lower, upper, 1)
    # R3's chain under each body, in turns (K1, K3, K4, K4, K3, K1).
    bodies = {"K1": chain,
              "K3": NonceSearcher("cmu440", device=dev, peel=True,
                                  hoist=False),
              "K4": NonceSearcher("cmu440", device=dev, peel=True)}
    body_ms, body_answers = {kern: [] for kern in bodies}, {}
    for kern in ("K1", "K3", "K4", "K4", "K3", "K1"):
        body_ms[kern].append(event_ms(lambda: body_answers.__setitem__(
            kern, bodies[kern].search(lower, upper))))
    if len(set(body_answers.values())) != 1:
        fail(f"R3's chain differs between bodies: {body_answers}")
    # The mouse's range: 6 blocks, 10^5 + 1 nonces.
    mouse_times = in_turns(0, 10 ** 5, 20)
    plans = list(chain.plan(lower, upper))
    floors = [bound_floors(p.lanes, needed_int_ops(
        p.rem, p.k, int(p.template.shape[0])), dev_info) for p in plans]
    # The plain chain: the plain scan and fold of ops.searchop on the
    # card, over four 2^20-lane windows (its pace is ~30 M lanes/s).
    wins = [next(iter(chain.plan(b * 10 ** 9, b * 10 ** 9 + (1 << 20) - 1)))
            for b in range(1, 5)]

    def plain_chain():
        carry = searchop.carry_init().to(dev)
        for p in wins:
            hi, lo, idx = search.span_scan(p.midstate, p.template, p.lo_i,
                                           p.lo_i, p.hi_i, p.lanes,
                                           rem=p.rem, k=p.k, device=dev)
            carry = searchop.fold_argmin(carry, hi, lo, idx, p.base >> 32,
                                         p.base & M32)
        return words(carry)

    def kernel_chain():
        carry = search.devloop_carry(searchop.ARGMIN_OP, dev)
        for p in wins:
            sha256_cuda.sha256_argmin_fold(p.midstate, p.template, carry,
                                           p.lo_i, p.lo_i, p.hi_i, p.lanes,
                                           p.base, rem=p.rem, k=p.k,
                                           device=dev)
        return words(carry)

    if plain_chain() != kernel_chain():
        fail("K6 chain over the 2^20-lane windows disagrees with plain")
    plain_ms = cuda_ms(plain_chain, 1)
    ms_small = cuda_ms(kernel_chain, 5)
    # The until chain where it does lane work: one launch from a fresh
    # carry to the first hit of the hit block, which must fold that hit.
    hp, t, f_idx = hit

    def until_to_hit():
        carry = search.devloop_carry(searchop.UNTIL_OP, dev)
        sha256_cuda.sha256_until_fold(
            hp.midstate, hp.template, carry, hp.lo_i, hp.lo_i, hp.hi_i,
            hp.lanes, t >> 32, t & M32, hp.base, rem=hp.rem, k=hp.k,
            device=dev)
        return carry
    got = searchop.decode_until(until_to_hit().cpu(), hp.base)
    if got[:2] != (True, hp.base + f_idx):
        fail(f"K6 until chain over the hit block: {got[:2]} != "
             f"(True, {hp.base + f_idx})")
    to_hit_ms = cuda_ms(until_to_hit, 5)
    hit_needed = needed_int_ops(hp.rem, hp.k, int(hp.template.shape[0]),
                                target=True)
    # R4's range through search_until: the chain to the first hit, then
    # launches that do no lane work.
    r4 = NonceSearcher("cmu440", device=dev)
    r4_answer = {}
    r4_ms = cuda_ms(lambda: r4_answer.__setitem__(
        "r", r4.search_until(0, 1 << 32, R4_TARGET)), 3)
    r4_plans = list(r4.plan(0, 1 << 32))
    hit_nonce = r4_answer["r"][1]
    upto = [(p, min(p.lanes, hit_nonce - p.base - p.lo_i + 1))
            for p in r4_plans if p.base + p.lo_i <= hit_nonce]
    r4_lanes = sum(n for _, n in upto)
    r4_bound = sum(bound_ms(n, needed_int_ops(p.rem, p.k,
                                              int(p.template.shape[0]),
                                              target=True), dev_info)[0]
                   for p, n in upto)
    # Where R4's time goes: digit classes 1-7 (7 blocks, 10^7 nonces) and
    # the class-8 block up to the hit, each through search_until alone.
    r4_parts = {name: cuda_ms(lambda: r4.search_until(lo, hi, R4_TARGET), 3)
                for name, lo, hi in (("classes_1_7", 0, 10 ** 7 - 1),
                                     ("class_8", 10 ** 7, 10 ** 8 - 1))}
    # A chained until launch after a hit: the carry says found, so the
    # launch over a whole 10^9 block does no lane work.
    (p,) = list(chain.plan(10 ** 9, 2 * 10 ** 9 - 1))
    found = search.devloop_carry(searchop.UNTIL_OP, dev)
    found[0] = 1
    before = words(found)
    noop_ms = cuda_ms(lambda: sha256_cuda.sha256_until_fold(
        p.midstate, p.template, found, p.lo_i, p.lo_i, p.hi_i, p.lanes, 0,
        0, p.base, rem=p.rem, k=p.k, device=dev), 20)
    if words(found) != before:
        fail("a chained until launch after a hit changed the carry")
    # K6's reduce-and-fold kernels alone, over one full wave's partials of
    # their search kernels on the rates block (the folds' inputs: seeded
    # keys, a lowest hit of none), on the card, over 200 launches each.
    import numpy as np
    alone = {}
    for name, entry in (("argmin", sha256_cuda.ENTRY_ARGMIN),
                        ("until", sha256_cuda.ENTRY_UNTIL)):
        count = sha256_cuda.default_grid(dev, "rolled", entry, 0)
        partials = int32_words(np.random.default_rng(446).integers(
            0, M32, size=3 * count)).to(dev)
        f_min = None if name == "argmin" else int32_words([M32]).to(dev)
        c = search.devloop_carry(searchop.ARGMIN_OP if f_min is None
                                 else searchop.UNTIL_OP, dev)
        alone[name] = {
            "partials": count,
            "ms": device_ms(lambda: sha256_cuda.k6_fold(
                partials, c, p.base, device=dev, f_min=f_min)),
            # The partials and carry read once, the carry written.
            "bound_ms": (3 * count + 1 + 2 * c.numel()) * 4 / 3.35e12 * 1e3,
            "bound_by": "bytes"}
    return {"blocks": len(plans), "launches": 2 * len(plans),
            "fold_alone": alone,
            "lanes": sum(p.lanes for p in plans),
            "ms": sum(times["chain"]) / 2,
            "bodies_ms": {kern: sum(v) / len(v) for kern, v in
                          body_ms.items()},
            "bodies_times": body_ms,
            "per_block_ms": sum(times["per_block"]) / 2,
            "times": times, "bound_ms": sum(f["ms"] for f in floors),
            "bound_by": "operations",
            "issue_floor_ms": sum(f["issue_ms"] for f in floors),
            "pipes_floor_ms": sum(f["pipes_ms"] for f in floors),
            "int32_only_ms": sum(f["int32_only_ms"] for f in floors),
            "mouse": {"range": [0, 10 ** 5], "blocks": 6,
                      "ms": sum(mouse_times["chain"]) / 2,
                      "per_block_ms": sum(mouse_times["per_block"]) / 2,
                      "times": mouse_times},
            "plain_windows": len(wins), "plain_lanes": len(wins) * (1 << 20),
            "plain_ms": plain_ms, "ms_at_plain_lanes": ms_small,
            "until_to_hit": {
                "base": hp.base, "hit_lane": f_idx, "ms": to_hit_ms,
                "bound_ms": bound_ms(f_idx - hp.lo_i + 1, hit_needed,
                                     dev_info)[0]},
            "until_r4": {"range": [0, 1 << 32], "answer": r4_answer["r"],
                         "blocks": len(r4_plans),
                         "lanes_to_hit": r4_lanes, "ms": r4_ms,
                         "bound_ms": r4_bound, "parts_ms": r4_parts},
            "until_after_hit_ms": noop_ms}


def batch_rows(jobs) -> tuple:
    """The rows and segments one batched dispatch gives K5 for ``jobs``
    (a row and a segment per job and 10^k block)."""
    rows = [(p.midstate, p.template, p.lo_i, p.lo_i, p.hi_i, p.lanes, p.rem,
             p.k) for s, lo, hi in jobs for p in s.plan(lo, hi)]
    return rows, list(range(len(rows)))


def segmin_bound(rows, dev_info: dict, plan_words: int = 49) -> dict:
    """:func:`bound_floors` for K5 over ``rows``, one segment each: the
    integer work each row's lanes need (``needed_int_ops``) against the
    bytes it must move (the plan table and four words of block table a row
    in, 12 bytes per segment out)."""
    ops = [sum(r[5] * needed_int_ops(r[6], r[7], int(r[1].shape[0]))[j]
               for r in rows) for j in (0, 1, 2)]
    return bound_floors(1, ops, dev_info,
                        (4 * (plan_words + 4) + 12) * len(rows))


def launch_delta(fn) -> tuple:
    """(fn's result, the kernel launches it made, by kernel)."""
    from distributed_bitcoinminer_tpu_torch.ops import sha256_cuda
    before = dict(sha256_cuda.launches)
    out = fn()
    return out, {k: n - before[k] for k, n in sha256_cuda.launches.items()
                 if n != before[k]}


def even_blocks(work: list, grid: int, threads: int) -> list:
    """The even grid share K5's proportional one is timed against: every
    row with a valid lane gets ``grid / rows`` blocks, at least one and
    never more than its runs of lanes fill."""
    return [0 if v <= 0 else max(1, min(-(-v // threads),
                                        round(grid / len(work))))
            for v in work]


def segmin_split(rows, seg, dev, **kw) -> tuple:
    """K5's call on ``rows`` cut in two: (the mean CUDA-event ms of its
    launches alone, the plan table prepared once; the mean host ms of
    preparing the table and copying it to the card)."""
    import torch
    from distributed_bitcoinminer_tpu_torch.ops import sha256_cuda
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        batch = sha256_cuda.prepare_segmin(rows, seg, device=dev, **kw)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 10 * 1e3
    return cuda_ms(batch.launch, 20), host_ms


def rates_k5(dev_info: dict, dev, one_block: dict) -> dict:
    """K5 over the eight mice of 10^6 nonces (56 rows) through the
    searcher's batched dispatch against the same eight jobs through their
    own K1/K6 chains, in turns (chains, K5, K5, chains); K5 alone on those
    rows with each row's share of the grid proportional to its lanes (the
    wrapper's) and with an even share (:func:`even_blocks` in its place),
    and the plain version on them; and K5 over eight
    rows of 10^8 lanes (1-block tail) beside K1's time per 10^9."""
    from distributed_bitcoinminer_tpu_torch.ops import search, sha256_cuda
    jobs = mice_jobs(dev)
    s0 = jobs[0][0]
    shapes = {"k5": lambda: s0.finalize_batch(s0.dispatch_batch(jobs)),
              "chains": lambda: [s.search(lo, hi) for s, lo, hi in jobs]}
    answers, launches, times = {}, {}, {"k5": [], "chains": []}
    for name, fn in shapes.items():
        answers[name], launches[name] = launch_delta(fn)
    if answers["k5"] != answers["chains"]:
        fail(f"K5 mice batch {answers['k5']} != per-job chains "
             f"{answers['chains']}")
    reps = 20
    for name in ("chains", "k5", "k5", "chains"):
        times[name].append(event_ms(lambda: [shapes[name]()
                                             for _ in range(reps)]) / reps)
    rows, seg = batch_rows(jobs)
    kernel_ms = cuda_ms(lambda: sha256_cuda.sha256_segmin(
        rows, seg, device=dev), 20)
    launch_only_ms, host_prep_ms = segmin_split(rows, seg, dev)
    lane_share = sha256_cuda._segmin_blocks
    sha256_cuda._segmin_blocks = even_blocks
    try:
        even_ms = cuda_ms(lambda: sha256_cuda.sha256_segmin(
            rows, seg, device=dev), 20)
    finally:
        sha256_cuda._segmin_blocks = lane_share
    plain_ms = cuda_ms(lambda: search.span_segmin_scan(rows, seg,
                                                       device=dev), 1)
    floors = segmin_bound(rows, dev_info)
    # The same rows under the peeled bodies (K4's rows carry their hoist),
    # and, to tell the rows' mix of tail shapes from the bodies' own cost,
    # the eight jobs all on one message (one shape per digit class); each
    # set timed in turns (rolled, K3, K4, K4, K3, rolled).
    from distributed_bitcoinminer_tpu_torch.ops.sha256_torch import \
        build_hoist

    def bodies_in_turns(rset, sset) -> dict:
        with_hoist = [r + (build_hoist(r[0], r[1], r[6], r[7]).ops,)
                      for r in rset]
        calls = {"K5": lambda: sha256_cuda.sha256_segmin(rset, sset,
                                                          device=dev),
                 "K3": lambda: sha256_cuda.sha256_segmin(
                     rset, sset, device=dev, peel=True),
                 "K4": lambda: sha256_cuda.sha256_segmin(
                     with_hoist, sset, device=dev, peel=True)}
        want = words(calls["K5"]().reshape(-1))
        for kern in ("K3", "K4"):
            if words(calls[kern]().reshape(-1)) != want:
                fail(f"{kern} on the batch rows disagrees with K5")
        ms = {kern: [] for kern in calls}
        for kern in ("K5", "K3", "K4", "K4", "K3", "K5"):
            ms[kern].append(cuda_ms(calls[kern], 10))
        return {kern: sum(v) / len(v) for kern, v in ms.items()}
    one_rows, one_seg = batch_rows([(jobs[0][0], 0, 10 ** 6)] * len(jobs))
    in_turns = {"mixed_messages": bodies_in_turns(rows, seg),
                "one_message": bodies_in_turns(one_rows, one_seg)}
    with_hoist = [r + (build_hoist(r[0], r[1], r[6], r[7]).ops,)
                  for r in rows]
    peeled = {kern: {"kernel_ms": in_turns["mixed_messages"][kern],
                     "bound_ms": segmin_bound(
                         rows, dev_info, 185 if kern == "K4" else 49)["ms"]}
              for kern in ("K3", "K4")}
    for kern, rr in (("K3", rows), ("K4", with_hoist)):
        peeled[kern]["launch_only_ms"], peeled[kern]["host_prep_ms"] = \
            segmin_split(rr, seg, dev, peel=True)
    mice = {"jobs": len(jobs), "rows": len(rows),
            "lanes": sum(r[5] for r in rows),
            "kernel_ms": kernel_ms, "launch_only_ms": launch_only_ms,
            "host_prep_ms": host_prep_ms,
            "batch_ms": sum(times["k5"]) / 2,
            "chains_ms": sum(times["chains"]) / 2, "times": times,
            "launches": launches, "fetches": {"k5": 1, "chains": len(jobs)},
            "even_share_ms": even_ms, "plain_ms": plain_ms,
            "bound_ms": floors["ms"], "bound_by": floors["by"],
            "issue_floor_ms": floors["issue_ms"],
            "pipes_floor_ms": floors["pipes_ms"],
            "int32_only_ms": floors["int32_only_ms"], "peeled": peeled,
            "bodies_in_turns": in_turns}
    brows, bseg = batch_rows([(s0, b * 10 ** 9, b * 10 ** 9 + 10 ** 8 - 1)
                              for b in range(1, 9)])
    big_ms = cuda_ms(lambda: sha256_cuda.sha256_segmin(brows, bseg,
                                                       device=dev), 3)
    lanes = sum(r[5] for r in brows)
    wide_floors = segmin_bound(brows, dev_info)
    wide = {"rows": len(brows), "lanes": lanes, "rem": brows[0][6],
            "k": brows[0][7], "nblocks": int(brows[0][1].shape[0]),
            "ms": big_ms, "ms_per_1e9": big_ms * 1e9 / lanes,
            "k1_ms_per_1e9": one_block["ms"] * 1e9 / one_block["lanes"],
            "bound_ms": wide_floors["ms"], "bound_by": wide_floors["by"],
            "issue_floor_ms": wide_floors["issue_ms"],
            "pipes_floor_ms": wide_floors["pipes_ms"],
            "int32_only_ms": wide_floors["int32_only_ms"]}
    return {"mice": mice, "wide": wide}


def rates_until_shapes(dev) -> dict:
    """The two difficulty shapes on R4's two chunks served back to back by
    one searcher, as one miner would serve them: the chain
    (``search_until``), and one K2 launch per block read in ascending
    order with no lookahead and with one launch of lookahead. In turns
    (chain, per-block, lookahead, lookahead, per-block, chain); host wall
    seconds from the first chunk's start to each chunk's answer."""
    import torch
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
    s = NonceSearcher("cmu440", device=dev)
    shapes = {
        "chain": lambda lo, hi: s.search_until(lo, hi, R4_TARGET),
        "per_block": lambda lo, hi: per_block_until(
            s, lo, hi, R4_TARGET, lambda p, th, tl: k2_words(p, th, tl, dev)),
        "per_block_lookahead": lambda lo, hi: per_block_until(
            s, lo, hi, R4_TARGET, lambda p, th, tl: k2_words(p, th, tl, dev),
            lookahead=1)}
    runs = {name: [] for name in shapes}
    answers = {}
    for name in ("chain", "per_block", "per_block_lookahead",
                 "per_block_lookahead", "per_block", "chain"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = shapes[name](*R4_CHUNKS[0])
        t1 = time.perf_counter()
        second = shapes[name](*R4_CHUNKS[1])
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        runs[name].append({"first_s": t1 - t0, "second_s": t2 - t0,
                           "drained_s": t3 - t0})
        answers.setdefault(name, (first, second))
        if answers[name] != (first, second) \
                or answers[name] != answers["chain"]:
            fail(f"difficulty shape {name}: {first, second} != chain "
                 f"{answers['chain']}")
    return {"chunks": [list(c) for c in R4_CHUNKS],
            "answers": [list(a) for a in answers["chain"]],
            "runs": runs,
            "mean_second_s": {name: sum(r["second_s"] for r in v) / len(v)
                              for name, v in runs.items()}}


def rates_mesh(dev_info: dict, dev, hit: tuple) -> dict:
    """The mesh chains on card 0: R3's arg-min chain on meshes of 1, 2 and
    4 shards against the single-device K6 chain, in turns (K6, 1, 2, 4, 4,
    2, 1, K6); the until chain on 4 shards against the single-device one,
    in turns, to the first hit of the ``hit`` block (twice K6, 4, 4, K6,
    each turn's time kept; the shards after the hit's share its lowest
    hit and hash nothing) and over that block with a target nothing
    meets; each mesh fold (4 rows) on the card alone, over 200 launches (:func:`device_ms`),
    against its plain version; and, on a box with more than one card,
    :func:`rates_multi_card`."""
    import torch
    from distributed_bitcoinminer_tpu_torch.models import (MeshNonceSearcher,
                                                           NonceSearcher)
    from distributed_bitcoinminer_tpu_torch.ops import searchop, sha256_cuda
    from distributed_bitcoinminer_tpu_torch.ops.search import devloop_carry
    from distributed_bitcoinminer_tpu_torch.parallel.mesh_search import (
        fold_rows_argmin, fold_rows_until)

    r3 = {"K6": NonceSearcher("cmu440", device=dev),
          **{n: MeshNonceSearcher("cmu440", devices=[dev] * n)
             for n in (1, 2, 4)}}
    before = dict(sha256_cuda.launches)
    r3_ms, r3_answer = in_turns(r3, ("K6", 1, 2, 4, 4, 2, 1, "K6"),
                                lambda s: s.search(0, 1 << 32))
    hp, t, f_idx = hit
    lower, upper = hp.base + hp.lo_i, hp.base + hp.hi_i
    until = {"K6": r3["K6"], 4: r3[4]}
    raw = {}
    until_ms, until_answer = in_turns(
        until, ("K6", 4, 4, "K6") * 2,
        lambda s: s.search_until(lower, upper, t), raw)
    if until_answer[1:] != (hp.base + f_idx, True):
        fail(f"the mesh until chain over the hit block: {until_answer}")
    miss_ms, miss_answer = in_turns(
        until, ("K6", 4, 4, "K6"),
        lambda s: s.search_until(lower, upper, 0))
    if miss_answer[2]:
        fail(f"the mesh until chain hit with a target of 0: {miss_answer}")
    launches = {k: n - before[k] for k, n in sha256_cuda.launches.items()}
    print(f"hit_scope {r3[4].hit_scope} (4 shards on card 0)", flush=True)
    rows = int32_words([[7, 1, 5], [7, 1, 3], [M32] * 3, [0, 9, 2]]).to(dev)
    rows5 = int32_words([[0, M32, 7, 1, 5], [1, 40, 7, 1, 3],
                         [0] + [M32] * 4, [1, 9, 0, 9, 2]]).to(dev)
    carry = devloop_carry(searchop.ARGMIN_OP, dev)
    ucarry = devloop_carry(searchop.UNTIL_OP, dev)
    folds = {
        "argmin_ms": device_ms(lambda: sha256_cuda.mesh_fold_argmin(
            rows, carry, M32, device=dev)),
        "until_ms": device_ms(lambda: sha256_cuda.mesh_fold_until(
            rows5, ucarry, M32, device=dev)),
        "argmin_host_ms": cuda_ms(lambda: sha256_cuda.mesh_fold_argmin(
            rows, carry, M32, device=dev), 200),
        "argmin_plain_ms": cuda_ms(lambda: fold_rows_argmin(
            carry, rows, M32), 20),
        "until_plain_ms": cuda_ms(lambda: fold_rows_until(
            ucarry, rows5, M32), 20),
        "rows": 4,
        # Each fold reads its rows and carry once and writes the carry.
        "bound_ms": (4 * 5 * 4 + 2 * 4 * 8) / 3.35e12 * 1e3,
        "bound_by": "bytes"}
    if torch.cuda.device_count() > 1:
        multi_card = rates_multi_card(dev, hit)
    else:
        multi_card = {"not_run": "the box has one card: the cross-card "
                                 "branch (peer hit words, row copies "
                                 "between cards, one fold per card) runs "
                                 "with --cross-card on a box with several"}
    return {"r3_ms": r3_ms, "r3_answer": list(r3_answer),
            "r3_bound_ms": sum(bound_ms(p.lanes, needed_int_ops(
                p.rem, p.k, int(p.template.shape[0])), dev_info)[0]
                for p in r3["K6"].plan(0, 1 << 32)),
            "hit_scope": r3[4].hit_scope,
            "until_to_hit_ms": until_ms, "until_to_hit_times": raw,
            "until_answer": list(until_answer),
            "until_to_hit_over_k6": until_ms["4"] / until_ms["K6"],
            "until_no_hit_ms": miss_ms, "until_no_hit_answer":
                list(miss_answer),
            "launches": launches, "folds": folds, "multi_card": multi_card}


def in_turns(searchers: dict, order: tuple, fn, raw=None) -> tuple:
    """``fn(searcher)`` timed by :func:`event_ms` for each key of
    ``order`` in turn: the mean milliseconds by key, and the one answer
    they all gave (they must agree); each turn's milliseconds by key go
    into ``raw`` when given."""
    times, answers = {key: [] for key in searchers}, {}
    for key in order:
        times[key].append(event_ms(lambda: answers.__setitem__(
            key, fn(searchers[key]))))
    if len(set(answers.values())) != 1:
        fail(f"the mesh chains disagree: {answers}")
    if raw is not None:
        raw.update({str(key): v for key, v in times.items()})
    return {str(key): sum(v) / len(v) for key, v in times.items()}, \
        next(iter(answers.values()))


def rates_multi_card(dev, hit: tuple) -> dict:
    """R3's arg-min chain, and the until chain to the first hit of the
    ``hit`` block and over it with a target nothing meets, over a mesh of
    every card against the K6 chain on card ``dev`` and against the same
    mesh in ``"card"`` scope (hits shared on each card only, as without
    peer access), in turns (twice K6, mesh,
    card scope, card scope, mesh, K6; each turn's time kept), after one
    untimed run of each over 10^6 nonces (arg-min and until) and of the
    until chain to that hit (a card's first launches load its kernels,
    and its first hit writes to the other cards' memory); the answers
    must agree. Prints the mesh's ``hit_scope`` on a line of its own."""
    import torch
    from distributed_bitcoinminer_tpu_torch.models import (MeshNonceSearcher,
                                                           NonceSearcher)
    count = torch.cuda.device_count()
    every = [f"cuda:{i}" for i in range(count)]
    cards = {"K6": NonceSearcher("cmu440", device=dev),
             "all_cards": MeshNonceSearcher("cmu440", devices=every),
             "card_scope": MeshNonceSearcher("cmu440", devices=every)}
    scope = cards["all_cards"].hit_scope
    print(f"hit_scope {scope}", flush=True)
    # The same mesh as it runs where a pair of cards lacks peer access:
    # hits shared only on each card.
    cards["card_scope"]._hit_scope = "card"
    hp, t, f_idx = hit
    for searcher in cards.values():
        searcher.search(0, 10 ** 6)
        searcher.search_until(0, 10 ** 6, 0)
        searcher.search_until(hp.base + hp.lo_i, hp.base + hp.hi_i, t)
    order = ("K6", "all_cards", "card_scope", "card_scope", "all_cards",
             "K6") * 2
    raw = {"r3": {}, "until_to_hit": {}, "until_no_hit": {}}
    r3_ms, r3_answer = in_turns(cards, order, lambda s: s.search(0, 1 << 32),
                                raw["r3"])
    until_ms, until_answer = in_turns(
        cards, order, lambda s: s.search_until(hp.base + hp.lo_i,
                                               hp.base + hp.hi_i, t),
        raw["until_to_hit"])
    if until_answer[1:] != (hp.base + f_idx, True):
        fail(f"the multi-card until chain over the hit block: "
             f"{until_answer}")
    miss_ms, miss_answer = in_turns(
        cards, order, lambda s: s.search_until(hp.base + hp.lo_i,
                                               hp.base + hp.hi_i, 0),
        raw["until_no_hit"])
    return {"cards": count, "hit_scope": scope, "times": raw, "r3_ms": r3_ms,
            "r3_answer": list(r3_answer),
            "until_to_hit_ms": until_ms, "until_answer": list(until_answer),
            "until_no_hit_ms": miss_ms, "until_no_hit_answer":
                list(miss_answer)}


def run_tune(outdir: str, int32_per_lane: dict) -> dict:
    """``tools.tune`` as a subprocess at its default span, given this
    run's INT32 instructions a nonce of the kernels in ``int32_per_lane``:
    its four lines by probe name."""
    out = subprocess.run([sys.executable, "-m", f"{PKG}.tools.tune", "24",
                          *(f"{k}={n}" for k, n in int32_per_lane.items())],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    with open(os.path.join(outdir, "tune.txt"), "w") as f:
        f.write(out.stdout + out.stderr)
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    if out.returncode != 0 or len(lines) != 4:
        fail(f"tools.tune: rc {out.returncode}, {out.stdout[-2000:]!r} "
             f"{out.stderr[-2000:]!r}")
    return {ln["probe"]: ln for ln in lines}


def phase_rates(dev_info: dict, outdir: str) -> dict:
    import torch
    dev = torch.device("cuda", 0)
    info = {"K1": rates_k1(dev_info, outdir, dev)}
    hit = hit_block(dev)
    info["K2"] = rates_k2(dev_info, outdir, dev, info["K1"]["one_block"],
                          hit)
    info["K5"] = rates_k5(dev_info, dev, info["K1"]["one_block"])
    info["K6"] = rates_k6(dev_info, dev, hit)
    info["until_shapes"] = rates_until_shapes(dev)
    info["K6mesh"] = rates_mesh(dev_info, dev, hit)
    one = info["K1"]["one_block"]
    info["tune"] = run_tune(outdir, k7_int32_per_lane(one))
    info["pipes"] = pipe_shares(info, dev_info)
    info.update({"sms": dev_info["sms"],
                 "clocks_max_sm_mhz": dev_info["clocks_max_sm_mhz"],
                 "clocks_sm_after": nvidia_smi("clocks.sm"),
                 "nvidia_smi": dev_info["nvidia_smi"]})
    emit("rates", **info)
    return info


def phase_census(rates: dict, e2e: dict, outdir: str) -> dict:
    """``tools.trace_census`` as a subprocess: one 2^29-lane K1 search and
    R3's chain under ``torch.profiler``, given this run's census of K1's
    lane body on that block's tail (the SASS of its fixed-shape build by
    pipe, and the work a nonce needs, ``needed_int_ops``). The profiled
    K1 search is held to a direct search of its span at 37 blocks, and
    the profiled chain to R3's answer on the arg-min path (``e2e``).
    Prints the idle share and the nonces/s from device time beside the
    card's name and power limit."""
    import torch
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
    from distributed_bitcoinminer_tpu_torch.tools.trace_census import \
        SPAN_DATA
    one = rates["K1"]["one_block"]
    sass = one["sass_pipes_per_lane"]
    needed = (one["needed_int_ops_per_lane"],
              one["needed_int32_ops_per_lane"],
              one["needed_rotates_per_lane"])
    census = {"sass_all": sass["all"], "sass_int32": sass["int32"],
              "sass_fma": sass["fma"], "sass_other": sass["other"],
              "needed_all": needed[0], "needed_int32": needed[1],
              "needed_rotates": needed[2],
              "needed_pipes": pipes_per_lane(needed)}
    out = subprocess.run([sys.executable, "-m", f"{PKG}.tools.trace_census",
                          "29", *(f"{k}={v}" for k, v in census.items())],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    with open(os.path.join(outdir, "census.txt"), "w") as f:
        f.write(out.stdout + out.stderr)
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    if out.returncode != 0 or len(lines) != 1:
        fail(f"tools.trace_census: rc {out.returncode}, "
             f"{out.stdout[-2000:]!r} {out.stderr[-2000:]!r}")
    info = lines[0]
    card = nvidia_smi("name,power.limit")
    info["nvidia_smi"] = card
    for key in ("k1", "r3"):
        rec = info[key]
        if not 0.0 <= rec["idle_share"] < 1.0 or rec["kernel_ms"] <= 0:
            fail(f"census {key}: {rec}")
    k1, r3 = info["k1"], next(r for r in e2e["requests"]
                              if r["request"] == "R3")
    if [info["r3"]["lower"], info["r3"]["upper"]] != [0, r3["max_nonce"] + 1]:
        fail(f"census r3: its span is not R3's: {info['r3']}")
    want = {"k1": list(NonceSearcher(
        SPAN_DATA, device=torch.device("cuda", 0), grid=37).search(
            k1["lower"], k1["upper"])), "r3": [r3["hash"], r3["nonce"]]}
    for key, answer in want.items():
        rec = info[key]
        if rec["answer"] != answer:
            fail(f"census {key}: the profiled answer {rec['answer']} != "
                 f"{answer}")
        rec["answer_checked_against"] = answer
    print("census: " + "; ".join(
        f"{key} {info[key]['lanes']} nonces idle share "
        f"{info[key]['idle_share']:.4f} of {info[key]['window_ms']:.3f} ms, "
        f"{info[key]['nonces_per_s_device']:.6g} nonces/s from device time"
        for key in ("k1", "r3")) + f"; K1 {census['sass_int32']:.2f} INT32 "
        f"/ {census['sass_fma']:.2f} FMA / {census['sass_other']:.2f} other "
        f"instructions a nonce ({card})", flush=True)
    emit("census", **info)
    return info


def pipe_shares(rates: dict, dev_info: dict) -> dict:
    """K1's and K4's SASS instructions a nonce by pipe on each rates block
    (INT32, FMA: IMAD and VIADD, other), and where each measured rate
    sits: its share of the nonce rate that K7's measured INT32
    instructions a second allow at the kernel's INT32 count, of the issue
    bound (128 instructions a clock per SM) and of each pipe's 64 lanes a
    clock, at the card's maximum SM clock."""
    k7 = rates["tune"]["K7"]
    clk_hz = float(dev_info["clocks_max_sm_mhz"].split()[0]) * 1e6
    sm_clocks = dev_info["sms"] * clk_hz
    out = {}
    for case, c in rates["K1"].items():
        for kern, r in (("K1", c), ("K4", c["K4"])):
            pipes, rate = r["sass_pipes_per_lane"], r["nonces_per_s"]
            out.setdefault(kern, {})[case] = {
                **pipes, "nonces_per_s": rate,
                "int32_ceiling_share":
                    rate * pipes["int32"] / k7["int32_insns_per_s"],
                "issue_share": rate * pipes["all"]
                / (sm_clocks * RATE_ISSUE_PER_CLK_PER_SM),
                "int32_pipe_share": rate * pipes["int32"]
                / (sm_clocks * RATE_INT32_PER_CLK_PER_SM),
                "fma_pipe_share": rate * pipes["fma"]
                / (sm_clocks * RATE_FMA_PER_CLK_PER_SM)}
    return out


def kernels_line(kernel: dict, e2e: dict, rates: dict) -> dict:
    """The ``kernels`` JSON object: every kernel of the paths, its
    launches on them, its check against its plain version and its
    times."""
    src = f"{PKG}/csrc/sha256_argmin.cu"
    launches = {k: sum(path[k] for path in e2e["launches"].values())
                for k in KERNELS}
    one, k2, k6 = rates["K1"]["one_block"], rates["K2"], rates["K6"]
    k5 = rates["K5"]
    return {"kernels": [
        {"name": "sha256_argmin", "route": "cuda", "source": src,
         "replaces": "ops/sha256_pallas.py:649 (pallas_search_span, in the "
                     "JAX package)",
         "launches": launches["K1"], "checked": True,
         "max_abs_err": kernel["K1"]["max_abs_err"],
         "ms": one["ms"], "lanes": one["lanes"],
         "plain_ms": one["plain_ms_2p22"], "plain_lanes": 1 << 22,
         "ms_at_plain_lanes": one["ms_2p22"],
         "bound_ms": one["bound_ms"], "bound_by": one["bound_by"],
         "bound_issue_ms": one["issue_floor_ms"],
         "bound_pipes_ms": one["pipes_floor_ms"],
         "int32_only_ms": one["int32_only_ms"],
         "sass_int32_pipe_ms": one["sass_int32_pipe_ms"],
         "sass_pipes_per_lane": one["sass_pipes_per_lane"],
         "library_ms": None},
        {"name": "sha256_until", "route": "cuda", "source": src,
         "replaces": "ops/sha256_pallas.py:680 (pallas_search_span_until, "
                     "in the JAX package)",
         "launches": launches["K2"], "checked": True,
         "max_abs_err": kernel["K2"]["max_abs_err"],
         "ms": k2["ms"], "lanes": k2["lanes"],
         "plain_ms": k2["plain_ms_2p22"], "plain_lanes": 1 << 22,
         "ms_at_plain_lanes": k2["ms_2p22"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "bound_issue_ms": k2["issue_floor_ms"],
         "bound_pipes_ms": k2["pipes_floor_ms"],
         "int32_only_ms": k2["int32_only_ms"],
         "ms_to_first_hit": k2["first_hit"]["ms_to_hit"],
         "bound_ms_to_first_hit": k2["first_hit"]["bound_ms_to_hit"],
         "until_after_hit_ms": k6["until_after_hit_ms"],
         "first_hit_lane": k2["first_hit"]["hit_lane"],
         "library_ms": None},
        {"name": "sha256_segmin", "route": "cuda", "source": src,
         "replaces": "ops/sha256_pallas.py:191 (pallas_search_span_batch, "
                     "via pallas_segmin :162, in the JAX package)",
         "launches": launches["K5"], "checked": True,
         "max_abs_err": kernel["K5"]["max_abs_err"],
         "ms": k5["mice"]["kernel_ms"],
         "launch_only_ms": k5["mice"]["launch_only_ms"],
         "rows": k5["mice"]["rows"],
         "lanes": k5["mice"]["lanes"],
         "batch_dispatch_fetch_ms": k5["mice"]["batch_ms"],
         "per_job_chains_ms": k5["mice"]["chains_ms"],
         "plain_ms": k5["mice"]["plain_ms"],
         "bound_ms": k5["mice"]["bound_ms"],
         "bound_by": k5["mice"]["bound_by"],
         "bound_issue_ms": k5["mice"]["issue_floor_ms"],
         "bound_pipes_ms": k5["mice"]["pipes_floor_ms"],
         "int32_only_ms": k5["mice"]["int32_only_ms"],
         "host_table_ms": k5["mice"]["host_prep_ms"],
         "wide_rows_ms_per_1e9": k5["wide"]["ms_per_1e9"],
         "wide_rows_bound_ms": k5["wide"]["bound_ms"],
         "library_ms": None},
        {"name": "sha256_argmin_fold+sha256_until_fold", "route": "cuda",
         "source": src,
         "replaces": "ops/sha256_pallas.py:882 and :919 "
                     "(_pallas_devloop_span_jit, _pallas_devloop_until_jit, "
                     "in the JAX package)",
         "launches": launches["K6"], "checked": True,
         "max_abs_err": kernel["K6"]["max_abs_err"],
         "ms": k6["ms"], "lanes": k6["lanes"],
         "per_block_k1_ms": k6["per_block_ms"],
         "plain_ms": k6["plain_ms"], "plain_lanes": k6["plain_lanes"],
         "ms_at_plain_lanes": k6["ms_at_plain_lanes"],
         "bound_ms": k6["bound_ms"], "bound_by": k6["bound_by"],
         "bound_issue_ms": k6["issue_floor_ms"],
         "bound_pipes_ms": k6["pipes_floor_ms"],
         "int32_only_ms": k6["int32_only_ms"],
         "until_ms_to_hit": k6["until_to_hit"]["ms"],
         "until_lanes_to_hit": k6["until_to_hit"]["hit_lane"] + 1,
         "until_bound_ms_to_hit": k6["until_to_hit"]["bound_ms"],
         "until_r4_ms": k6["until_r4"]["ms"],
         "until_r4_bound_ms": k6["until_r4"]["bound_ms"],
         "until_after_hit_ms": k6["until_after_hit_ms"],
         "fold_alone": k6["fold_alone"],
         "library_ms": None},
        *(peeled_entry(kern, src, launches[kern], kernel[kern], rates)
          for kern, _, _ in PEELED),
        mesh_entry(src, launches["K6mesh"], kernel["K6mesh"], rates),
        k7_entry(kernel["K7"], rates)]}


def mesh_entry(src: str, launches: int, check: dict, rates: dict) -> dict:
    """K6's mesh bodies in the ``kernels`` line: one mesh fold launch (4
    rows) on the card beside its plain version and its bound; R3's chain
    by shard count beside the single-device K6 chain; the until chain to
    K2's first hit on 4 shards beside the single-device chain and K2's
    bound to that hit."""
    mesh = rates["K6mesh"]
    folds = mesh["folds"]
    to_hit = mesh["until_to_hit_ms"]["4"]
    hit_bound = rates["K2"]["first_hit"]["bound_ms_to_hit"]
    return {
        "name": "mesh_fold_argmin+mesh_fold_until+sha256_until_shard",
        "route": "cuda", "source": src,
        "replaces": "ops/sha256_pallas.py:833 and :853 (pallas_devloop_scan,"
                    " pallas_devloop_until_scan, with the pmin merge and fold"
                    " of parallel/mesh_search.py:389-407 and :434-455, in "
                    "the JAX package)",
        "launches": launches, "checked": True,
        "max_abs_err": check["max_abs_err"],
        "ms": folds["argmin_ms"], "until_fold_ms": folds["until_ms"],
        "fold_host_ms": folds["argmin_host_ms"],
        "rows": folds["rows"], "plain_ms": folds["argmin_plain_ms"],
        "until_plain_ms": folds["until_plain_ms"],
        "bound_ms": folds["bound_ms"], "bound_by": folds["bound_by"],
        "r3_chain_ms_by_shards": mesh["r3_ms"],
        "r3_chain_bound_ms": mesh["r3_bound_ms"],
        "until_to_hit_ms": to_hit,
        "until_to_hit_single_device_ms": mesh["until_to_hit_ms"]["K6"],
        "until_to_hit_bound_ms": hit_bound,
        "until_to_hit_bound_by": "operations",
        "until_to_hit_share_of_bound": hit_bound / to_hit,
        "until_no_hit_ms": mesh["until_no_hit_ms"],
        "hit_scope": mesh["hit_scope"],
        "multi_card": mesh["multi_card"], "library_ms": None}


#: What one lane-iteration of K7 needs, whatever the compiler emits: per
#: chain a rotate (SHF) and an xor (LOP3), which only the INT32 pipe
#: executes, and a 3-input add, one IADD3 there or two IMADs on the FMA
#: pipe. With the adds on the FMA pipe, 16 INT32 instructions at 64 a
#: clock and 32 issued at 128 a clock both take 0.25 clock per SM, the
#: least over every split of the adds (the loop's own instructions are
#: left out: unrolling amortises them).
K7_CLOCKS_PER_LANE_ITER = max(16 / RATE_INT32_PER_CLK_PER_SM,
                              32 / RATE_ISSUE_PER_CLK_PER_SM)


def k7_int32_per_lane(one_block: dict) -> dict:
    """This run's INT32 instructions a nonce of K1's and K4's lane loops
    on the 1-block tail, from their fixed-shape SASS."""
    return {"K1": one_block["sass_alu_insns_per_lane"],
            "K4": one_block["K4"]["sass_alu_insns_per_lane"]}


def k7_entry(check: dict, rates: dict) -> dict:
    """K7 in the ``kernels`` line: the tuning tool's launch at full
    occupancy; its bound, the operations the function needs at the
    maximum SM clock (:data:`K7_CLOCKS_PER_LANE_ITER`), beside the bound
    of its emitted SASS at the issue rate; the plain version on one wave;
    and the nonce/s ceilings of K1 and K4 that the measured INT32 rate
    implies, from this run's SASS counts of their lane loops."""
    k7 = rates["tune"]["K7"]
    clk_hz = float(rates["clocks_max_sm_mhz"].split()[0]) * 1e6
    per_sm_s = rates["sms"] * clk_hz / 1e3
    lane_iters = k7["lanes"] * k7["iters"]
    bound = lane_iters * K7_CLOCKS_PER_LANE_ITER / per_sm_s
    sass_bound = (lane_iters * k7["sass_insns_per_iter"]
                  / RATE_ISSUE_PER_CLK_PER_SM / per_sm_s)
    counts = k7_int32_per_lane(rates["K1"]["one_block"])
    return {
        "name": "alu_probe", "route": "cuda",
        "source": f"{PKG}/csrc/alu_probe.cu",
        "replaces": "scripts/tpu_tune.py:51 (vpu_kernel, its pallas_call at "
                    ":69, in the JAX package's tuning tool)",
        "launches": k7["launches"], "checked": True,
        "max_abs_err": check["max_abs_err"],
        "ms": k7["ms"], "lanes": k7["lanes"], "iters": k7["iters"],
        "plain_ms": check["plain_ms"], "plain_lanes": check["lanes"],
        "ms_at_plain_lanes": check["ms"],
        "bound_ms": bound, "bound_by": "operations",
        "clocks_per_lane_iter_needed": K7_CLOCKS_PER_LANE_ITER,
        "sass_issue_bound_ms": sass_bound,
        "sass_insns_per_iter": k7["sass_insns_per_iter"],
        "sass_int32_insns_per_iter": k7["sass_int32_insns_per_iter"],
        "issued_per_clk_per_sm": k7["issued_per_clk_per_sm"],
        "int32_per_clk_per_sm": k7["int32_per_clk_per_sm"],
        "int32_fits_pipe": k7["int32_fits_pipe"],
        "ceiling_int32_per_lane": counts,
        "ceiling_nonces_per_s": {
            kern: k7["int32_insns_per_s"] / n for kern, n in counts.items()},
        "library_ms": None}


#: The TPU kernel each peeled body replaces (file:line in the JAX
#: package).
PEELED_REPLACES = {
    "K3": ("sha256_peel", "ops/sha256_pallas.py:548-595 (the peel branch "
           "of _kernel_body, DBM_PEEL=1 DBM_HOIST=0, in the JAX package)"),
    "K4": ("sha256_peel_hoisted", "ops/sha256_pallas.py:310-415 "
           "(_peel_hoisted, via _kernel_body :522-524, DBM_PEEL=1, in the "
           "JAX package)")}


def peeled_entry(kern: str, src: str, launches: int, check: dict,
                 rates: dict) -> dict:
    """A peeled body's entry of the ``kernels`` line: its times on the
    rates blocks beside K1's, on R3's chain, to K2's first hit and on
    the mice rows."""
    name, replaces = PEELED_REPLACES[kern]
    one = rates["K1"]["one_block"]
    mine = one[kern]
    return {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches, "checked": True,
        "max_abs_err": check["max_abs_err"],
        "ms": mine["ms"], "lanes": one["lanes"], "k1_ms": one["ms"],
        "plain_ms": mine["plain_ms_2p22"], "plain_lanes": 1 << 22,
        "ms_at_plain_lanes": mine["ms_2p22"],
        "bound_ms": one["bound_ms"], "bound_by": one["bound_by"],
        "bound_issue_ms": one["issue_floor_ms"],
        "bound_pipes_ms": one["pipes_floor_ms"],
        "int32_only_ms": one["int32_only_ms"],
        "sass_alu_insns_per_lane": mine["sass_alu_insns_per_lane"],
        "two_block_ms": rates["K1"]["two_block"][kern]["ms"],
        "two_block_digit_free_ms":
            rates["K1"]["two_block_digit_free"][kern]["ms"],
        "r3_chain_ms": rates["K6"]["bodies_ms"][kern],
        "until_ms_to_first_hit": rates["K2"]["first_hit"][kern]["ms_to_hit"],
        "mice_rows_ms": rates["K5"]["mice"]["peeled"][kern]["kernel_ms"],
        "mice_rows_launch_only_ms":
            rates["K5"]["mice"]["peeled"][kern]["launch_only_ms"],
        "sass_pipes_per_lane": mine["sass_pipes_per_lane"],
        "library_ms": None}


# ------------------------------------------------------------- --against

def host_ms(fn, reps: int) -> float:
    """Mean host milliseconds of ``fn`` over ``reps`` runs after one
    warm-up, the device synchronised before and after."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def against_cases(dev) -> dict:
    """What ``--against`` times in turns, by name, through the wrappers of
    whichever copy of the package is first on ``sys.path`` (calls that
    the parent commit's package takes as this one does):
    ``{name: setup}``, ``setup()`` giving ``(reps, make, answer, host)``:
    each turn times the callable ``make()`` returns, over ``reps`` runs
    after one, between CUDA events (on the host's clock with ``host``),
    and ``answer`` of its result must be the same for both packages.

    K1 and K4 over the three rates blocks and R3's K6 chain under both
    bodies; K2 over each rates block with a target nothing meets, to the
    first hit of :func:`hit_block`, and one chained launch after a hit,
    and under K4's body over the first block and to that hit; K6's until
    chain over that block, to its hit and with no target met; K5 on the
    eight mice's 56 rows, rolled and under K4 (the call, its launches
    alone, the host's table and its copy), and over eight rows of 10^8
    lanes of each tail shape; the mesh searcher on card 0, R3's chain on
    1, 2 and 4 shards, and the until chain on 4 shards to that first hit
    and over its block with a target nothing meets."""
    from distributed_bitcoinminer_tpu_torch.models import (MeshNonceSearcher,
                                                           NonceSearcher)
    from distributed_bitcoinminer_tpu_torch.ops import searchop, sha256_cuda
    from distributed_bitcoinminer_tpu_torch.ops.search import devloop_carry
    from distributed_bitcoinminer_tpu_torch.ops.sha256_torch import \
        build_hoist
    cases, memo = {}, {}

    def once(key, fn):
        if key not in memo:
            memo[key] = fn()
        return memo[key]

    def block(name):
        """A rates block's plan: (args, kw, its K4 hoist)."""
        def make():
            _, data, lower, upper = next(b for b in RATE_BLOCKS
                                         if b[0] == name)
            (p,) = list(NonceSearcher(data, device=dev).plan(lower, upper))
            return ((p.midstate, p.template, p.lo_i, p.lo_i, p.hi_i,
                     p.lanes), dict(rem=p.rem, k=p.k, device=dev),
                    build_hoist(p.midstate, p.template, p.rem, p.k).ops, p)
        return once(("block", name), make)

    def hit():
        """:func:`hit_block`'s (until arguments, kw, K4 hoist)."""
        def make():
            hp, t, _ = once("hit_block", lambda: hit_block(dev))
            return ((hp.midstate, hp.template, hp.lo_i, hp.lo_i, hp.hi_i,
                     hp.lanes, t >> 32, t & M32),
                    dict(rem=hp.rem, k=hp.k, device=dev),
                    build_hoist(hp.midstate, hp.template, hp.rem, hp.k).ops)
        return once("hit", make)

    def mice(peeled):
        def make():
            rows, seg = batch_rows(mice_jobs(dev))
            if peeled:
                rows = [r + (build_hoist(r[0], r[1], r[6], r[7]).ops,)
                        for r in rows]
            return rows, seg, dict(device=dev, peel=peeled)
        return once(("mice", peeled), make)

    def flat(out):
        return words(out.reshape(-1))

    def first_two(out):
        return words(out)[:2]

    for name, *_ in RATE_BLOCKS:
        cases[f"K1 {name}"] = lambda name=name: (
            3, lambda: (lambda: sha256_cuda.sha256_argmin(
                *block(name)[0], **block(name)[1])), words, False)
        cases[f"K4 {name}"] = lambda name=name: (
            3, lambda: (lambda: sha256_cuda.sha256_argmin(
                *block(name)[0], **block(name)[1], peel=True,
                hoist=block(name)[2])), words, False)
        cases[f"K2 {name}, no hit"] = lambda name=name: (
            2, lambda: (lambda: sha256_cuda.sha256_until(
                *block(name)[0], 0, 0, **block(name)[1])), words, False)
    for kern, peel in (("K1", False), ("K4", True)):
        cases[f"R3's K6 chain, {kern}"] = lambda peel=peel: (
            1, lambda: (lambda s=NonceSearcher("cmu440", device=dev,
                                               peel=peel): s.search(
                0, 1 << 32)), list, False)
    cases["K2 to its hit"] = lambda: (
        5, lambda: (lambda: sha256_cuda.sha256_until(*hit()[0], **hit()[1])),
        first_two, False)

    def after_hit():
        args, kw, _, p = block("one_block")
        found = devloop_carry(searchop.UNTIL_OP, dev)
        found[0] = 1
        return lambda: sha256_cuda.sha256_until_fold(
            p.midstate, p.template, found, p.lo_i, p.lo_i, p.hi_i, p.lanes,
            0, 0, p.base, **kw)
    cases["K2 chained, after a hit"] = lambda: (200, after_hit, words, False)

    def chained(target_of):
        """K6's until chain over hit_block's block from a fresh carry (the
        carry reset on the card before each launch)."""
        def make():
            hp, t, _ = once("hit_block", lambda: hit_block(dev))
            init = devloop_carry(searchop.UNTIL_OP, dev)
            carry = init.clone()
            target = target_of(t)

            def run():
                carry.copy_(init)
                return sha256_cuda.sha256_until_fold(
                    hp.midstate, hp.template, carry, hp.lo_i, hp.lo_i,
                    hp.hi_i, hp.lanes, target >> 32, target & M32, hp.base,
                    rem=hp.rem, k=hp.k, device=dev)
            return run
        return make
    cases["K6 until chain to its hit"] = lambda: (
        5, chained(lambda t: t), lambda c: words(c)[:3], False)
    cases["K6 until chain, no hit"] = lambda: (
        2, chained(lambda t: 0), words, False)
    cases["K2 under K4, one_block, no hit"] = lambda: (
        2, lambda: (lambda: sha256_cuda.sha256_until(
            *block("one_block")[0], 0, 0, **block("one_block")[1],
            peel=True, hoist=block("one_block")[2])), words, False)
    cases["K2 under K4, to its hit"] = lambda: (
        5, lambda: (lambda: sha256_cuda.sha256_until(
            *hit()[0], **hit()[1], peel=True, hoist=hit()[2])),
        first_two, False)
    for kern, peeled in (("K5", False), ("K5 under K4", True)):
        cases[f"{kern}, mice rows: call"] = lambda peeled=peeled: (
            20, lambda: (lambda: sha256_cuda.sha256_segmin(
                mice(peeled)[0], mice(peeled)[1], **mice(peeled)[2])),
            flat, False)
        cases[f"{kern}, mice rows: launches alone"] = lambda peeled=peeled: (
            20, lambda: sha256_cuda.prepare_segmin(
                mice(peeled)[0], mice(peeled)[1], **mice(peeled)[2]).launch,
            flat, False)
        cases[f"{kern}, mice rows: host table"] = lambda peeled=peeled: (
            50, lambda: (lambda: sha256_cuda.prepare_segmin(
                mice(peeled)[0], mice(peeled)[1], **mice(peeled)[2])),
            None, True)
    # Eight rows of 10^8 lanes of each tail shape: "cmu440" from 10^9, R2's
    # message from 10^8 (the last digit in block 1), the 50-character one
    # from 10^9 (a digit-free second block).
    # The mesh on card 0 through the searcher: R3's chain on 1, 2 and 4
    # shards, and the until chain on 4 shards to the hit of hit_block's
    # block and over it with a target nothing meets.
    for shards in (1, 2, 4):
        cases[f"R3's mesh chain, {shards} shards"] = lambda shards=shards: (
            1, lambda: (lambda s=MeshNonceSearcher(
                "cmu440", devices=[dev] * shards): s.search(0, 1 << 32)),
            list, False)

    def mesh_until(target_of):
        def make():
            hp, t, _ = once("hit_block", lambda: hit_block(dev))
            s = MeshNonceSearcher("cmu440", devices=[dev] * 4)
            return lambda: s.search_until(hp.base + hp.lo_i,
                                          hp.base + hp.hi_i, target_of(t))
        return make
    cases["mesh until to its hit, 4 shards"] = lambda: (
        3, mesh_until(lambda t: t), list, False)
    cases["mesh until, no hit, 4 shards"] = lambda: (
        2, mesh_until(lambda t: 0), list, False)
    for name, data, lower in (("one_block", "cmu440", 10 ** 9),
                              ("two_block", R2_DATA, 10 ** 8),
                              ("two_block_digit_free", DIGIT_FREE_DATA,
                               10 ** 9)):
        def wide(data=data, lower=lower):
            s = NonceSearcher(data, device=dev)
            rows, seg = batch_rows([(s, lower + b * 10 ** 8,
                                     lower + (b + 1) * 10 ** 8 - 1)
                                    for b in range(8)])
            return lambda: sha256_cuda.sha256_segmin(rows, seg, device=dev)
        cases[f"K5, eight 10^8 rows, {name}"] = lambda wide=wide: (
            2, wide, flat, False)
    return cases


def build_report() -> dict:
    """This process's package: the checkout it lies in, and for each lane
    body the registers and spill stores of its K2 and K5 instantiations
    (from the ptxas report of a build made in this process, else none)
    and each entry's resident blocks per SM by variant."""
    from distributed_bitcoinminer_tpu_torch.ops import sha256_cuda
    out = {"root": os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(sha256_cuda.__file__))))}
    for body in sha256_cuda.BODIES:
        lib = sha256_cuda.load(body)
        ptxas = sha256_cuda.build_info.get(body, {}).get("ptxas", "")
        out[body] = {
            "kernels": {name: k for name, k in ptxas_kernels(ptxas).items()
                        if re.match(r"sha256_(until|segmin)_kernel", name)},
            "blocks_per_sm": {
                entry: [lib.dbmt_sha256_blocks_per_sm(e, v)
                        for v in range(3)]
                for e, entry in enumerate(("argmin", "until", "segmin"))}}
    return out


def worker(root: str) -> int:
    """``--worker ROOT``: serve :func:`against_cases` with the package of
    the checkout at ``ROOT``, built there, one JSON line a request on
    standard input (``{"case": name}``) and a reply on standard output
    (``{"ms", "answer"}``, or ``{"error"}``), after a first line with
    :func:`build_report`. Standard output carries nothing else."""
    import traceback
    sys.path.insert(0, os.path.abspath(root))
    replies, sys.stdout = sys.stdout, sys.stderr

    def reply(obj):
        replies.write(json.dumps(obj) + "\n")
        replies.flush()
    try:
        import torch

        from distributed_bitcoinminer_tpu_torch.ops import sha256_cuda
        sha256_cuda.build_all()
        dev = torch.device("cuda", 0)
        report = build_report()
        if report["root"] != os.path.abspath(root):
            fail(f"imported the package under {report['root']}, not the "
                 f"one under {root}")
        reply(report)
        cases, made = against_cases(dev), {}
        for line in sys.stdin:
            name = json.loads(line)["case"]
            if name not in made:
                made[name] = cases[name]()
            reps, make, answer, host = made[name]
            fn = make()
            got = fn()
            ms = host_ms(fn, reps) if host else cuda_ms(fn, reps)
            reply({"ms": ms, "answer": None if answer is None
                   else list(answer(got))})
    except BaseException:
        reply({"error": traceback.format_exc()[-3000:]})
        return 1
    return 0


class Worker:
    """A ``--worker`` process for the checkout at ``root``, its standard
    error in ``outdir/worker_<who>.log``."""

    def __init__(self, root: str, who: str, outdir: str):
        self.who = who
        self.log = open(os.path.join(outdir, f"worker_{who}.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", root],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.log,
            text=True)

    def read(self) -> dict:
        line = self.proc.stdout.readline()
        got = json.loads(line) if line else {"error": "no reply"}
        if "error" in got:
            fail(f"the {self.who} worker failed (worker_{self.who}.log): "
                 f"{got['error']}")
        return got

    def ask(self, case: str) -> dict:
        self.proc.stdin.write(json.dumps({"case": case}) + "\n")
        self.proc.stdin.flush()
        return self.read()

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.log.close()


def against(dev_info: dict, outdir: str, old: Worker) -> dict:
    """The package against another checkout's (``old``, the parent
    commit's), each through its own wrappers and kernels in a
    :class:`Worker`, in turns on this card: every case of
    :func:`against_cases`, old, new, new, old, the two answers equal.
    Also each build's K2 and K5 instantiations (:func:`build_report`)."""
    import torch
    new = Worker(ROOT, "new", outdir)
    workers = {"old": old, "new": new}
    try:
        info = {"builds": {who: w.read() for who, w in workers.items()},
                "cases": {}}
        for name in against_cases(torch.device("cuda", 0)):
            times, answers = {"old": [], "new": []}, {}
            for who in ("old", "new", "new", "old"):
                got = workers[who].ask(name)
                times[who].append(got["ms"])
                answers[who] = got["answer"]
            if answers["old"] != answers["new"]:
                fail(f"{name}: the two packages disagree: {answers}")
            o, n = (sum(v) / len(v) for v in (times["old"], times["new"]))
            case = info["cases"][name] = {
                "old_ms": times["old"], "new_ms": times["new"],
                "old_mean_ms": o, "new_mean_ms": n, "old_over_new": o / n}
            emit("against_case", name=name, **case)
    finally:
        for w in workers.values():
            w.stop()
    info["nvidia_smi"] = dev_info["nvidia_smi"]
    emit("against", **info)
    return info


def cross_card(outdir: str) -> dict:
    """``--cross-card``, on a box with several cards: only what spans
    cards and what it is held to. The mesh paths of :func:`run_mesh`
    (``DBMT_MESH_DEVICES`` naming every card), each answer held to a
    direct search on card 0 and the launches to
    :func:`check_mesh_paths`; a pod of one rank a card (rows over NCCL)
    on R3 and R4, held the same way (:func:`check_pod`), its seconds
    beside the mesh's; the follower-death drill on that pod
    (:data:`CROSS_DRILL_JOB`, the last rank killed, held to a direct
    search); the row gather's cost; then :func:`rates_multi_card`."""
    import torch
    from distributed_bitcoinminer_tpu_torch.models import NonceSearcher
    from distributed_bitcoinminer_tpu_torch.ops import sha256_cuda
    if torch.cuda.device_count() < 2:
        fail("--cross-card needs a box with at least two cards")
    dev = torch.device("cuda", 0)
    sha256_cuda.build_all()
    mesh = run_mesh(outdir)
    direct = {}
    for name, data, max_nonce, *target in ARGMIN_REQUESTS + UNTIL_REQUESTS:
        s = NonceSearcher(data, device=dev)
        got = s.search_until(0, max_nonce + 1, target[0]) if target \
            else s.search(0, max_nonce + 1)
        direct[name] = {"hash": got[0], "nonce": got[1]}
    check_mesh_paths(mesh, direct)
    # A pod of one rank a card (rows over NCCL) on R3 and R4, beside the
    # one-process mesh of the same cards.
    cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    pod = run_pod(outdir, tag="pod_cross", devices_of=cards,
                  argmin_names=("R3",))
    check_pod(pod, direct)
    if not pod["backend"].startswith("nccl"):
        fail(f"the cross-card pod's rows went over {pod['backend']}")
    # The follower-death drill over NCCL: a dead peer shows there as a
    # collective that hangs (gloo raises at once), so the owner must leave
    # through its bound.
    drill = run_pod_drill(outdir, tag="pod_cross_drill", devices_of=cards,
                          job=CROSS_DRILL_JOB)
    got = NonceSearcher(CROSS_DRILL_JOB[0], device=dev).search(
        0, CROSS_DRILL_JOB[1] + 1)
    check_pod_drill(drill, {"hash": got[0], "nonce": got[1]})
    print(f"pod drill over {pod['backend']}: rank {len(cards) - 1} killed "
          f"mid-job, owner exit {drill['owner_rc']} after "
          f"{drill['owner_exit_s']:.3f} s (bound {POD_DRILL_TIMEOUT_S} s; "
          f"peer error logged: {drill['peer_error_logged']}, bound logged: "
          f"{drill['bound_logged']}); a plain miner served "
          f"{len(drill['spare_chunks'])} chunk(s), answer equal to a direct "
          "search", flush=True)
    gather = pod_gather_ms(cards)
    mesh_s = {r["request"]: r["seconds"]
              for r in mesh["default"]["requests"]}
    for r in pod["requests"]:
        print(f"pod of {len(cards)} ranks x 1 card: {r['request']} "
              f"{r['seconds']:.4f} s over {pod['backend']}, "
              f"{mesh_s[r['request']]:.4f} s on the one-process mesh of "
              f"the same cards", flush=True)
    print(f"pod: {gather['ms_per_gather'][0]:.4f} ms a row gather over "
          f"{gather['backend']} (synchronised)", flush=True)
    info = {"mesh": mesh, "direct": direct, "pod": pod, "pod_drill": drill,
            "pod_gather": gather,
            "multi_card": rates_multi_card(dev, hit_block(dev))}
    emit("cross_card", **info)
    return info


def main() -> int:
    if sys.argv[1:2] == ["--worker"] and len(sys.argv) == 3:
        return worker(sys.argv[2])
    if sys.argv[1:2] == ["--fault-miner"] and len(sys.argv) == 4:
        return fault_miner(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--chaos-storm"] and len(sys.argv) == 3:
        return chaos_storm(sys.argv[2])
    if sys.argv[1:] == ["--analysis-card"]:
        return analysis_card()
    if sys.argv[1:2] == ["--pod-gather"] and len(sys.argv) == 6:
        return pod_gather_rank(sys.argv[2], int(sys.argv[3]),
                               int(sys.argv[4]), sys.argv[5])
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        print(f"chip_smoke: {PKG}/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    cross = sys.argv[1:] == ["--cross-card"]
    other = sys.argv[2] if len(sys.argv) == 3 \
        and sys.argv[1] == "--against" else None
    if sys.argv[1:] and not cross and other is None:
        print("usage: chip_smoke.py [--cross-card | --against CHECKOUT]",
              file=sys.stderr)
        return 2
    if other is not None and not os.path.isdir(os.path.join(other, PKG)):
        print(f"chip_smoke: no {PKG}/ in {other}", file=sys.stderr)
        return 2
    outdir = os.path.join(ROOT, "chiprun_out",
                          "chip_smoke_cross_card" if cross else
                          "chip_smoke_against" if other else "chip_smoke")
    os.makedirs(outdir, exist_ok=True)
    PHASES_LOG.append(os.path.join(outdir, "phases.jsonl"))
    open(PHASES_LOG[0], "w").close()
    t0 = time.monotonic()
    marks = [t0]
    ok = json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    if cross:
        phase_device()
        cross_card(outdir)
        emit("done", seconds=time.monotonic() - t0)
        print(ok, flush=True)
        return 0

    if other:
        dev_info = phase_device()
        old = Worker(os.path.abspath(other), "old", outdir)  # builds beside
        try:
            phase_build(outdir)
            phase_kernel()
        except BaseException:
            old.stop()
            raise
        against(dev_info, outdir, old)
        emit("done", seconds=time.monotonic() - t0)
        print(ok, flush=True)
        return 0

    def lap():
        marks.append(time.monotonic())
        return marks[-1] - marks[-2]
    dev_info = phase_device()
    phase_build(outdir)
    seconds = {"device+build": lap()}
    kernel = phase_kernel()
    seconds["kernel"] = lap()
    e2e = phase_e2e(outdir)
    seconds["e2e"] = lap()
    phase_harness(outdir, e2e)
    seconds["harness"] = lap()
    phase_analysis(outdir, e2e)
    seconds["analysis"] = lap()
    rates = phase_rates(dev_info, outdir)
    seconds["rates"] = lap()
    phase_census(rates, e2e, outdir)
    seconds["census"] = lap()
    emit("done", seconds=time.monotonic() - t0, phase_seconds=seconds)
    line = json.dumps(kernels_line(kernel, e2e, rates))
    print(line, flush=True)
    with open(PHASES_LOG[0], "a") as f:
        f.write(line + "\n")
    print(ok, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
