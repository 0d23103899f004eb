"""Unimem core: runtime data management on heterogeneous memory (the paper's
contribution), with HBM as the fast tier and pinned host memory as the slow
tier of one CUDA card."""

from .backends import available_backends, make_backend, register_backend
from .data_objects import DataObject, ObjectRegistry
from .faults import (ChannelHealth, ChaosBackend, CopyError, CopyFailedError,
                     CopyTimeoutError, DegradedServe, EvictionRollback,
                     FaultLog, FaultSpec, TransientCopyError, host_sub_seed)
from .histogram import Histogram, uniform_mass
from .instrumentation import (InstrumentationSource, ManualSource,
                              OperandAttributionSource, PhaseSample)
from .knapsack import Item, solve as knapsack_solve
from .monitor import VariationMonitor
from .mover import (AsyncTorchTierBackend, ChannelSimBackend, CpuPoolBackend,
                    CrossHostBackend, MoveRecord, TorchTierBackend,
                    ProactiveMover, SimTierBackend, SlackAwareMover)
from .perfmodel import (CalibrationConstants, InterconnectModel, LinkSpec,
                        Sensitivity, benefit, calibrate, classify,
                        consumed_bandwidth, cross_host_cost,
                        link_transfer_time, movement_cost, weight)
from .phase import (Phase, PhaseGraph, PhaseKind, PhaseTraceEvent,
                    build_phase_graph)
from .planner import (MoveOp, PhaseDecision, PlacementPlan, Planner,
                      ScheduledMove, emit_schedule)
from .policy import (BandwidthPartitionPolicy, PipelineState, PlacementPolicy,
                     PlanProgram, StageProvenance, UnimemPolicy,
                     available_policies, make_policy, register_policy)
from .profiler import ObjectPhaseProfile, PhaseProfiler
from .runtime import RuntimeConfig, UnimemRuntime
from .session import PhaseContext, Session, TierAudit
from .tenancy import (TENANT_SEP, TenantHandle, TenantSpec, apportion,
                      capacity_shares, channel_shares, per_tenant_p99,
                      tenant_of)
from .tiers import (MachineProfile, TierSpec, PROFILES, PAPER_DRAM_NVM,
                    STT_RAM, PCRAM, RERAM, TPU_V5E, TPU_V5E_VMEM,
                    H100_HBM_HOST,
                    V5E_PEAK_FLOPS_BF16, V5E_HBM_BW, V5E_ICI_BW)

__all__ = [
    "DataObject", "ObjectRegistry", "Histogram", "uniform_mass",
    "Item", "knapsack_solve",
    "VariationMonitor", "TorchTierBackend", "AsyncTorchTierBackend",
    "CpuPoolBackend", "ProactiveMover", "SimTierBackend",
    "ChannelSimBackend", "SlackAwareMover", "MoveRecord",
    "available_backends", "make_backend", "register_backend",
    "InstrumentationSource", "ManualSource", "OperandAttributionSource",
    "PhaseSample",
    "Session", "PhaseContext", "TierAudit",
    "ChannelHealth", "ChaosBackend", "CopyError", "CopyFailedError",
    "CopyTimeoutError", "DegradedServe", "EvictionRollback", "FaultLog",
    "FaultSpec", "TransientCopyError", "host_sub_seed",
    "TENANT_SEP", "TenantHandle", "TenantSpec", "apportion",
    "capacity_shares", "channel_shares", "per_tenant_p99", "tenant_of",
    "BandwidthPartitionPolicy", "CrossHostBackend",
    "CalibrationConstants", "InterconnectModel", "LinkSpec", "Sensitivity",
    "benefit", "calibrate", "classify", "consumed_bandwidth",
    "cross_host_cost", "link_transfer_time", "movement_cost", "weight",
    "Phase", "PhaseGraph", "PhaseKind", "PhaseTraceEvent", "build_phase_graph",
    "MoveOp", "PhaseDecision", "PlacementPlan", "Planner", "ScheduledMove",
    "emit_schedule",
    "PipelineState", "PlacementPolicy", "PlanProgram", "StageProvenance",
    "UnimemPolicy", "available_policies", "make_policy", "register_policy",
    "ObjectPhaseProfile", "PhaseProfiler",
    "RuntimeConfig", "UnimemRuntime",
    "MachineProfile", "TierSpec", "PROFILES", "PAPER_DRAM_NVM", "STT_RAM",
    "PCRAM", "RERAM", "TPU_V5E", "TPU_V5E_VMEM", "H100_HBM_HOST",
    "V5E_PEAK_FLOPS_BF16", "V5E_HBM_BW", "V5E_ICI_BW",
]
