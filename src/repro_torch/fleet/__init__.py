"""Multi-replica serve fleet: topology-aware placement, affinity routing,
and measured-latency feedback.

Port of ``repro.fleet``: the same modules, names and file formats, on the
port's serve engine and cost model.

The paper's locality principle — keep dense traffic inside fully-connected
groups, minimize bytes crossing global links — applied one level above a
single job:

  * :mod:`placement`  — map each replica's tensor-parallel group onto the
    topology (``repro_torch.topology`` cost model) so TP collectives stay inside
    one fully-connected group; candidate placements are scored by
    predicted intra- vs global-link bytes per decode step;
  * :mod:`router`     — load-balance request traces across replicas with
    session/prefix affinity (same session hashes to the same replica for
    KV/prefix reuse) and least-loaded spill;
  * :mod:`replica`    — one ``ContinuousBatchingScheduler`` behind a
    uniform tick interface with drain (stop admitting, finish in-flight,
    release) and respawn;
  * :mod:`fleet`      — the fleet loop: route arrivals, tick replicas,
    feed measured per-replica EWMA tick latency back into routing;
  * :mod:`feedback`   — the persisted measurement store (the
    ``repro_torch.tuner.store`` pattern: one provenance-stamped JSON per
    ``(device_kind, topology, p)``).
"""

from .feedback import (Ewma, FleetFeedback, feedback_dir, feedback_path,
                       load_feedback, save_feedback)
from .fleet import Fleet, FleetConfig, FleetEvent
from .placement import (PlacementPlan, contiguous_placement, fleet_allocation,
                        format_plan, plan_placement, round_robin_placement,
                        score_placement)
from .replica import Replica, TickReport
from .router import AffinityRouter, affinity_key

__all__ = [
    "Ewma", "FleetFeedback", "feedback_dir", "feedback_path",
    "load_feedback", "save_feedback",
    "Fleet", "FleetConfig", "FleetEvent",
    "PlacementPlan", "contiguous_placement", "fleet_allocation",
    "format_plan", "plan_placement", "round_robin_placement",
    "score_placement",
    "Replica", "TickReport",
    "AffinityRouter", "affinity_key",
]
