"""Allocator interface: the MILP allocators (paper) and the equal-share
heuristic baseline (paper §5.1's comparison scheme)."""
from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Dict, List

from repro_torch.core.milp import (
    AllocationProblem,
    AllocationResult,
    TrainerSpec,
    project_current,
    solve_node_milp,
)
from repro_torch.core.milp_fast import reconstruct_map, solve_fast_milp


class Allocator(ABC):
    name = "base"

    @abstractmethod
    def allocate(self, prob: AllocationProblem) -> AllocationResult:
        ...


class MILPAllocator(Allocator):
    """Paper allocator.  ``mode='node'`` is the faithful §3 model;
    ``mode='fast'`` is the count-based reformulation (identical optimum,
    orders of magnitude faster — DESIGN.md beyond-paper item 1)."""

    def __init__(self, mode: str = "fast", time_limit: float = 30.0):
        assert mode in ("node", "fast")
        self.mode = mode
        self.time_limit = time_limit
        self.name = f"milp-{mode}"

    def allocate(self, prob: AllocationProblem) -> AllocationResult:
        if self.mode == "node":
            return solve_node_milp(prob, time_limit=self.time_limit)
        return solve_fast_milp(prob, time_limit=self.time_limit)


class EqualShareAllocator(Allocator):
    """Heuristic baseline: distribute idle nodes equally among Trainers
    (respecting each Trainer's min/max), FCFS for the remainder."""

    name = "equal-share"

    def allocate(self, prob: AllocationProblem) -> AllocationResult:
        nodes = sorted(prob.nodes)
        trainers = prob.trainers
        n = len(nodes)
        counts: Dict[int, int] = {t.id: 0 for t in trainers}
        if trainers:
            base = n // len(trainers)
            for t in trainers:
                counts[t.id] = min(t.n_max, base)
            # hand out the remainder FCFS (trainer order = arrival order)
            left = n - sum(counts.values())
            for t in trainers:
                if left <= 0:
                    break
                extra = min(left, t.n_max - counts[t.id])
                counts[t.id] += extra
                left -= extra
            # below-minimum shares go back to the pool, redistributed FCFS
            for t in trainers:
                if 0 < counts[t.id] < t.n_min:
                    left = counts[t.id]
                    counts[t.id] = 0
                    for t2 in trainers:
                        if left <= 0:
                            break
                        extra = min(left, t2.n_max - counts[t2.id])
                        if counts[t2.id] > 0 or extra >= t2.n_min:
                            counts[t2.id] += extra
                            left -= extra
        current = project_current(prob)
        allocation = reconstruct_map(nodes, trainers, current, counts)
        return AllocationResult(allocation=allocation, counts=counts,
                                objective=None, wall_time=0.0,
                                solver_status="heuristic")
