"""schedcheck — deterministic interleaving exploration for the port's
control plane (dbmcheck).

The dbmlint pack (the sibling ``analysis`` modules) proves STATIC facts
— a knob is documented, a blocking call stays off the loop. This
package proves SCHEDULING facts: it runs the real scheduler / QoS /
miner-pipeline state machines on a controlled event loop
(:mod:`.detloop`) where a picker — not wall-clock accident — chooses
every next step and a virtual clock drives every timer, then checks the
control plane's invariants after each explored schedule
(:mod:`.scenario`), over seed-driven random walks, bounded exhaustive
DFS, and replay/shrink of failing schedules (:mod:`.explore`).

Entry point: ``python -m distributed_bitcoinminer_tpu_torch.tools.dbmcheck``
(any printed seed spec replays its schedule bit-for-bit).

Unlike the rest of ``analysis/`` this package IMPORTS the control plane
(scheduler, qos, miner, replicas, gateway; the miner imports torch); it
is therefore not imported by
``analysis/__init__`` or the dbmlint CLI, keeping the lint leg's
import graph unchanged.
"""

from .detloop import DetLoop, Picker, RandomPicker, TracePicker
from .explore import (ExploreStats, explore_scenarios, format_spec,
                      parse_spec, replay, run_dfs, run_walks, shrink)
from .scenario import Ctx, Req, Scenario, ScheduleResult, execute
from .scenarios import ALL, FIXTURES, SCENARIOS

__all__ = [
    "DetLoop", "Picker", "RandomPicker", "TracePicker",
    "ExploreStats", "explore_scenarios", "format_spec", "parse_spec",
    "replay", "run_dfs", "run_walks", "shrink",
    "Ctx", "Req", "Scenario", "ScheduleResult", "execute",
    "ALL", "FIXTURES", "SCENARIOS",
]
