"""BFTrainerRuntime: the full system — real ElasticTrainers driven by the
MILP allocator over a replayed idle-node trace (counterpart of
``repro.elastic.runtime``, the same code over the port's trainer).

This is the deployable composition, now a thin facade over the shared
``ControlLoop`` with the ``LiveBackend`` (DESIGN.md §9): the *same*
policy engine that powers the trace-driven ``Simulator`` — FCFS admission
up to ``pj_max``, event coalescing, preemption handling, rescale-stall
accounting, adaptive ``t_fwd`` — executes each decision against live PyTorch
Trainers (rescale + train steps).  Trace time is scaled by ``time_scale``
so a week-long trace can be exercised in seconds of wall time while still
performing real training steps at each interval.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.core.allocator import Allocator, MILPAllocator
from repro_torch.core.backend import LiveBackend
from repro_torch.core.events import PoolEvent
from repro_torch.core.loop import ControlLoop, LoopStats
from repro_torch.core.scaling import ScalingCurve
from repro_torch.elastic.trainer import ElasticTrainer


@dataclass
class ManagedTrainer:
    """One live Trainer under BFTrainer management.

    ``weight`` (dimensionless), ``deadline`` (absolute trace-clock
    seconds) and ``budget`` (node-seconds) are per-job policy fields
    read by the matching objectives (``repro_torch.core.objectives``); they are
    inert under the default throughput policy.
    """

    id: int
    trainer: ElasticTrainer
    curve: ScalingCurve
    n_min: int = 1
    n_max: int = 8
    steps_done: int = 0
    samples_done: int = 0
    target_steps: Optional[int] = None
    weight: float = 1.0
    deadline: Optional[float] = None
    budget: Optional[float] = None

    @property
    def finished(self) -> bool:
        return (self.target_steps is not None
                and self.steps_done >= self.target_steps)


@dataclass
class RuntimeReport:
    steps: Dict[int, int]
    samples: Dict[int, int]
    losses: Dict[int, List[float]]
    rescales: Dict[int, int]
    events: int
    wall_time_s: float
    solver_wall_s: float
    # the shared policy-side report core (same shape the Simulator returns)
    stats: Optional[LoopStats] = None


class BFTrainerRuntime:
    def __init__(self, managed: Sequence[ManagedTrainer],
                 allocator: Optional[Allocator] = None, *,
                 t_fwd: Union[float, str] = 120.0,
                 steps_per_second: float = 1.0,
                 metric: str = "throughput", pj_max: int = 10,
                 coalesce_window: float = 0.0, sos2_points: int = 8,
                 objective=None, telemetry=None):
        self.managed = list(managed)
        self.allocator = allocator or MILPAllocator("fast")
        self.t_fwd = t_fwd
        self.steps_per_second = steps_per_second
        self.metric = metric
        self.pj_max = pj_max
        self.coalesce_window = coalesce_window
        self.sos2_points = sos2_points
        # allocation policy (repro_torch.core.objectives); None = throughput
        self.objective = objective
        # observation sink (repro_torch.obs); None = disabled
        self.telemetry = telemetry

    def run(self, events: Sequence[PoolEvent], *, time_scale: float = 1.0,
            max_steps_per_interval: int = 4,
            horizon: Optional[float] = None,
            measure_rescale_costs: bool = True) -> RuntimeReport:
        t0 = time.perf_counter()
        backend = LiveBackend(
            self.managed, time_scale=time_scale,
            steps_per_second=self.steps_per_second,
            max_steps_per_interval=max_steps_per_interval,
            metric=self.metric,
            measure_rescale_costs=measure_rescale_costs)
        loop = ControlLoop(events, backend.jobs(), self.allocator, backend,
                           t_fwd=self.t_fwd, pj_max=self.pj_max,
                           horizon=horizon, sos2_points=self.sos2_points,
                           coalesce_window=self.coalesce_window,
                           objective=self.objective,
                           telemetry=self.telemetry)
        stats = loop.run()
        return RuntimeReport(
            steps={m.id: m.steps_done for m in self.managed},
            samples={m.id: m.samples_done for m in self.managed},
            losses=backend.losses,
            rescales={m.id: len(m.trainer.rescale_history)
                      for m in self.managed},
            events=stats.events_processed,
            wall_time_s=time.perf_counter() - t0,
            solver_wall_s=stats.solver_wall_total,
            stats=stats)
