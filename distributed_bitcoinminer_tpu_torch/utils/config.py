"""Parameter blocks of the fair-share QoS plane and cross-request
coalescing, with the JAX package's defaults (its ``utils/config.py``
``QosParams`` and ``CoalesceParams``), cut to the fields the port reads.

Constructor arguments carry the settings; the server and miner CLIs read
them from the environment through :func:`qos_from_env` and
:func:`coalesce_from_env` (knobs documented in the port's README):

- ``DBMT_QOS_CHUNK_S`` (default 1.0): seconds of one miner's work per
  chunk of a chunked request;
- ``DBMT_QOS_WHOLESALE_S`` (default 5.0): requests estimated below this
  dispatch wholesale, like the stock path;
- ``DBMT_COALESCE`` (default 1): 0 turns off the scheduler's coalescing
  windows and the miner's drain into one batched launch;
- ``DBMT_PEEL`` (default 0, as the JAX package's ``DBM_PEEL``): 1 runs
  every search launch of the miner with the peeled lane body;
- ``DBMT_HOIST`` (default 1, as ``DBM_HOIST``): under ``DBMT_PEEL=1``,
  feed the peeled body the host hoist (K4); 0 runs it without (K3);
- ``DBMT_MESH_DEVICES`` (default: every visible CUDA device): the miner's
  mesh, a comma list of devices such as ``cuda:0,cuda:1``; a device may
  repeat (``cuda:0,cuda:0,cuda:0,cuda:0`` puts four shards on one card).
  A miner with at least two entries searches over the mesh
  (``MeshNonceSearcher``), as the JAX package's factory takes its mesh
  searcher on a box with more than one device.
"""

from __future__ import annotations

from dataclasses import dataclass

from ._env import float_env, int_env, str_env


@dataclass(frozen=True)
class QosParams:
    """Deficit-round-robin dispatch across tenants (client connections).

    A request estimated (at the pool's throughput EWMA) to scan longer
    than ``wholesale_s``, or one that arrives while chunked work is in
    flight, is split into ``chunk_s``-second chunks (at most
    ``max_chunks``) granted one at a time; each miner holds at most
    ``depth`` live QoS chunks. Smaller requests, and every request on a
    cold pool, dispatch wholesale through the stock path, which keeps
    single-tenant traffic bit-identical to the stock FIFO scheduler.
    ``max_inflight`` caps a tenant's granted-unanswered chunks (0 = no
    cap); ``weights`` maps tenant id strings to DRR weights, the others
    get ``default_weight``.
    """
    enabled: bool = True
    chunk_s: float = 1.0
    max_chunks: int = 4096
    depth: int = 2
    wholesale_s: float = 5.0
    max_inflight: int = 256
    default_weight: float = 1.0
    weights: tuple = ()            # ((tenant_id_str, weight), ...)

    def __post_init__(self):
        # chunk_s <= 0 pins the wholesale path (the 0-disables convention).
        if self.chunk_s <= 0:
            object.__setattr__(self, "wholesale_s", float("inf"))

    def weight_for(self, tenant) -> float:
        for key, w in self.weights:
            if key == str(tenant):
                return max(w, 1e-3)
        return max(self.default_weight, 1e-3)


@dataclass(frozen=True)
class CoalesceParams:
    """Cross-request batched dispatch.

    Scheduler side: within one QoS pump pass, small argmin chunks of
    different requests may be granted into one miner's coalescing window
    (up to ``lanes`` chunks), which counts as ONE live chunk against the
    QoS depth. Miner side: the pipelined miner drains up to ``lanes``
    queued small argmin chunks (at most ``max_nonces`` each) into one
    batched launch. A chunk is small when it holds at most ``max_nonces``
    nonces and, on a warm pool, at most ``small_s`` seconds of work.
    ``enabled=False`` (or ``max_nonces``/``small_s`` <= 0) is the stock
    one-chunk-one-launch path.
    """
    enabled: bool = True
    lanes: int = 8
    max_nonces: int = 1 << 20
    small_s: float = 0.25

    def __post_init__(self):
        if self.max_nonces <= 0 or self.small_s <= 0:
            object.__setattr__(self, "enabled", False)


def qos_from_env() -> QosParams:
    d = QosParams()
    return QosParams(
        chunk_s=float_env("DBMT_QOS_CHUNK_S", d.chunk_s),
        wholesale_s=float_env("DBMT_QOS_WHOLESALE_S", d.wholesale_s))


def coalesce_from_env() -> CoalesceParams:
    return CoalesceParams(enabled=int_env("DBMT_COALESCE", 1) != 0)


@dataclass(frozen=True)
class PeelParams:
    """The miner's lane body: ``peel`` runs the peeled body, K4 with the
    host ``hoist`` or K3 without (``NonceSearcher``'s ``peel`` and
    ``hoist``)."""
    peel: bool = False
    hoist: bool = True


def peel_from_env() -> PeelParams:
    return PeelParams(peel=int_env("DBMT_PEEL", 0) == 1,
                      hoist=int_env("DBMT_HOIST", 1) != 0)


def mesh_from_env(device="cuda") -> tuple:
    """The miner's mesh, as device names: ``DBMT_MESH_DEVICES`` split at
    its commas; unset or empty, every visible CUDA device when the miner
    runs on ``device`` of type ``cuda``, and none on the CPU. A miner
    takes the mesh when it has at least two entries."""
    names = tuple(x.strip() for x in str_env("DBMT_MESH_DEVICES", "")
                  .split(",") if x.strip())
    if names:
        return names
    import torch
    if torch.device(device).type != "cuda":
        return ()
    return tuple(f"cuda:{i}" for i in range(torch.cuda.device_count()))
