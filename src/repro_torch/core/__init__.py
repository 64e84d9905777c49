# The paper's primary contribution: MILP-based elastic resource allocation
# for DNN Trainers on unfillable idle nodes, and the event-driven control
# loop around it.  Copies of the framework-free ``repro.core`` modules the
# training path runs (``BFTrainerRuntime`` -> ``ControlLoop`` +
# ``LiveBackend``); the engine, greedy solver, metrics and simulator are
# not copied yet (ROADMAP.md, Queue 1).
from repro_torch.core.allocator import Allocator, EqualShareAllocator, \
    MILPAllocator
from repro_torch.core.backend import (
    AnalyticBackend,
    ExecutionBackend,
    LiveBackend,
    ServingBackend,
)
from repro_torch.core.events import (
    EventStreamError,
    Fragment,
    PoolEvent,
    fragments_to_events,
    merge_events,
    merge_fragments,
    pool_sizes,
    validate_events,
    validate_fragments,
)
from repro_torch.core.loop import ControlLoop, EventRecord, LoopStats, \
    TrainerJob
from repro_torch.core.milp import (
    AllocationProblem,
    AllocationResult,
    TrainerSpec,
    project_current,
    solve_node_milp,
)
from repro_torch.core.milp_fast import reconstruct_map, solve_fast_milp
from repro_torch.core.objectives import (
    OBJECTIVES,
    CostCap,
    DeadlineAware,
    LatencySLO,
    MaxMinFairness,
    Objective,
    Throughput,
    WeightedPriority,
    cached_value_table,
    resolve_objective,
)
from repro_torch.core.scaling import ScalingCurve, all_tab2_curves, \
    amdahl_curve, model_zoo_curves, tab2_curve
from repro_torch.core.tfwd import TfwdEstimator, resolve_tfwd
from repro_torch.core.trace import TraceStats, clip_fragments, \
    generate_summit_like, load_trace_csv, trace_stats

__all__ = [
    "Allocator", "EqualShareAllocator", "MILPAllocator",
    "AnalyticBackend", "ExecutionBackend", "LiveBackend", "ServingBackend",
    "ControlLoop", "EventRecord", "LoopStats", "TrainerJob",
    "cached_value_table",
    "EventStreamError", "Fragment", "PoolEvent", "fragments_to_events",
    "merge_events", "merge_fragments", "pool_sizes", "validate_events",
    "validate_fragments",
    "AllocationProblem", "AllocationResult", "TrainerSpec",
    "project_current", "solve_node_milp",
    "reconstruct_map", "solve_fast_milp",
    "OBJECTIVES", "CostCap", "DeadlineAware", "LatencySLO", "MaxMinFairness",
    "Objective", "Throughput", "WeightedPriority", "resolve_objective",
    "ScalingCurve", "all_tab2_curves", "amdahl_curve", "model_zoo_curves",
    "tab2_curve",
    "TfwdEstimator", "resolve_tfwd",
    "TraceStats", "clip_fragments", "generate_summit_like", "load_trace_csv",
    "trace_stats",
]
