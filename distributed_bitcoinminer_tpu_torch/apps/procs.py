"""The replica tier's state files: atomic JSON documents in a directory.

Counterpart of the state-file helpers of the JAX package's
``apps/procs.py`` (its multi-process replica tier: replica processes
beating into a state directory, a router publishing the membership, miner
agents and the spool-replicated cache). Only the helpers are ported so
far; the processes that use them are still to port. The layout::

    <statedir>/beat_<rid>.json       one Beat per replica, seq advancing
    <statedir>/membership.json       the ring and fencing ledger
    <statedir>/metrics_<role>_<rid>.json   a rollup snapshot blob

Every write is atomic (a temporary file renamed over the target), so a
reader sees the old or the new document, never a torn one.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

from .health import Beat, Membership
from .replicas import HashRing

__all__ = ["beat_path", "membership_path", "read_beats", "read_json",
           "read_membership", "resolve_owner", "write_json_atomic"]


def write_json_atomic(path: str, obj: dict) -> None:
    """Publish ``obj`` at ``path`` atomically (a rename on one
    filesystem)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(obj, fh, sort_keys=True)
    os.replace(tmp, path)


def read_json(path: str) -> Optional[dict]:
    """The document at ``path``, or None when it is missing or torn."""
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def beat_path(statedir: str, rid: int) -> str:
    return os.path.join(statedir, f"beat_{rid}.json")


def membership_path(statedir: str) -> str:
    return os.path.join(statedir, "membership.json")


def read_membership(statedir: str) -> Optional[Membership]:
    """The published membership, or None while none is (the caller backs
    off)."""
    d = read_json(membership_path(statedir))
    return Membership.from_dict(d) if d else None


def read_beats(statedir: str) -> List[Beat]:
    """Every well-formed beat file of the directory."""
    out = []
    try:
        names = os.listdir(statedir)
    except OSError:
        return out
    for name in names:
        if not (name.startswith("beat_") and name.endswith(".json")):
            continue
        d = read_json(os.path.join(statedir, name))
        if d is not None:
            try:
                out.append(Beat.from_dict(d))
            except (TypeError, KeyError):
                continue
    return out


def resolve_owner(statedir: str, key) -> Optional[Tuple[int, str]]:
    """The client-side ring: ``(rid, hostport)`` of the replica owning
    ``key``, or None when no membership or no live replica is published.

    The ring spans the SERVING replicas: live, and advertising at least
    one joined miner in their current incarnation's beat (a replica
    with no miner would queue the request forever while another served).
    While no replica holds a miner, every key resolves to the lowest live
    rid, where the first miner joins."""
    m = read_membership(statedir)
    if m is None or not m.live:
        return None
    counts = {b.rid: b.miners for b in read_beats(statedir)
              if b.rid in m.live
              and b.incarnation == m.live[b.rid]["incarnation"]}
    serving = sorted(r for r in m.live if counts.get(r, 0) > 0)
    rid = HashRing(serving or [min(m.live)]).owner(key)
    return rid, f"127.0.0.1:{m.live[rid]['port']}"
