"""Elastic fault-tolerant runtime: deterministic fault injection,
survivor-set rescheduling, and a self-healing serve fleet.

Port of ``repro.resilience``: the same modules, names, event specs and
plans, on the port's serve fleet and train step.  Three layers, one
fault model:

  * :mod:`repro_torch.resilience.chaos` — every fault is a scheduled
    :class:`~repro_torch.resilience.chaos.FaultEvent` (replica crash
    mid-tick, straggler tick, global-link slowdown, train-rank loss,
    store-file corruption), either written out explicitly or generated
    from a seed, so every chaos run is exactly reproducible.
  * :mod:`repro_torch.resilience.elastic` — on rank loss, rebuild the
    collective schedules at p' = p - k through the schedule IR's
    non-pow2 adapters, re-derive the tier stack over the degraded group
    occupancy, repartition the ZeRO bucket rows over the survivors, and
    resume from the last checkpoint bit-identically to a fresh p'-rank
    run.
  * :mod:`repro_torch.resilience.supervisor` — a self-healing layer over
    the serve fleet: per-tick heartbeats, crash detection that converts
    an unplanned replica exception into stop -> respawn with in-flight
    requests replayed from prompt + generated prefix, and deadline-based
    admission backpressure (shed, or re-queue with deterministic
    jittered backoff).
"""

from repro_torch.resilience.chaos import (CHAOS_KINDS, ChaosSchedule,
                                          FaultEvent, corrupt_file,
                                          degraded_topology, generate_events,
                                          parse_event, rank_loss_schedule)
from repro_torch.resilience.elastic import (SurvivorPlan, elastic_backend,
                                            elastic_restore,
                                            elastic_train_config,
                                            plan_survivors, replan_buckets,
                                            survivor_set)
from repro_torch.resilience.supervisor import (FleetSupervisor, ReplicaCrash,
                                               SupervisorConfig)

__all__ = [
    "CHAOS_KINDS", "ChaosSchedule", "FaultEvent", "corrupt_file",
    "degraded_topology", "generate_events", "parse_event",
    "rank_loss_schedule",
    "SurvivorPlan", "elastic_backend", "elastic_restore",
    "elastic_train_config", "plan_survivors", "replan_buckets",
    "survivor_set",
    "FleetSupervisor", "ReplicaCrash", "SupervisorConfig",
]
