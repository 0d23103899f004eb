"""Discrete-event tier simulator (Quartz-emulator analogue, paper §4)."""

from .cluster import (ClusterResult, ClusterSimulation, ShardPhaseSpec,
                      ShardedWorkload, moe_churn_multihost)
from .engine import (PhaseExec, SimObjectAccess, SimPhaseSpec, SimSource,
                     SimWorkload, SimulationEngine, SimResult,
                     simulate_stream_time, simulate_chase_time)
from .workloads import (cg_like, ft_like, bt_like, lu_like, sp_like, mg_like,
                        nek_like, NPB_WORKLOADS, lm_train_workload,
                        kv_serving, kv_serving_skewed, moe_expert_churn,
                        graph_chase, graph_chase_skewed, paged_attention,
                        power_law_density,
                        SCENARIO_WORKLOADS, SKEWED_SCENARIO_WORKLOADS,
                        tenant_serving, TENANT_SERVING_QOS,
                        chaos_gated_spec, chaos_heavy_spec,
                        CHAOS_FAULT_PROFILES)

__all__ = [
    "PhaseExec", "SimObjectAccess", "SimPhaseSpec", "SimSource",
    "SimWorkload", "SimulationEngine", "SimResult", "simulate_stream_time",
    "simulate_chase_time",
    "cg_like", "ft_like", "bt_like", "lu_like", "sp_like", "mg_like",
    "nek_like", "NPB_WORKLOADS", "lm_train_workload",
    "kv_serving", "kv_serving_skewed", "moe_expert_churn", "graph_chase",
    "graph_chase_skewed", "paged_attention", "power_law_density",
    "SCENARIO_WORKLOADS", "SKEWED_SCENARIO_WORKLOADS",
    "tenant_serving", "TENANT_SERVING_QOS",
    "chaos_gated_spec", "chaos_heavy_spec", "CHAOS_FAULT_PROFILES",
    "ClusterResult", "ClusterSimulation", "ShardPhaseSpec",
    "ShardedWorkload", "moe_churn_multihost",
]
