"""The mesh plane: one miner over several devices (shard windows, the
per-shard searches, and the merge and fold of their results), and pods:
one miner over several processes (``multihost``)."""

from .mesh_search import (make_mesh, mesh_carry, mesh_carry_init,
                          mesh_devloop_span, mesh_devloop_span_until,
                          mesh_lex_min, mesh_until_carry_init)
from .partition import device_windows

__all__ = ["device_windows", "make_mesh", "mesh_carry", "mesh_carry_init",
           "mesh_devloop_span", "mesh_devloop_span_until", "mesh_lex_min",
           "mesh_until_carry_init"]
