"""Aggregate (count-based) reformulation of the paper's MILP — beyond-paper
optimization (see DESIGN.md §2 and EXPERIMENTS.md §Perf-MILP).

Observation: idle nodes are homogeneous and migration is disallowed, so the
solution is fully determined by the *count* vector (N_1..N_J):

* feasibility — any count vector with Σ N_j ≤ |N| and N_j ∈ {0} ∪
  [N^min_j, N^max_j] is realizable without migration: a Trainer that shrinks
  keeps a subset of its own nodes; one that grows keeps all of them and
  takes free/released ones.  This is exactly the feasible set of the
  node-level model (Eqns 4–10): the XOR/no-migration constraints only force
  |Δ| = Σ u, i.e. keep-your-own-nodes, never *which* nodes;
* objective — Eqn 16 depends only on N_j and C_j.

Hence the optimal objective is identical while the variable count drops
from O(J·|N|) binaries to O(J) integers (+ SOS2 weights).  Property tests
(tests/test_milp.py) assert objective equality against the node-level
model on randomized instances.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.lp import MILPBuilder, sos2_block
from repro_torch.core.milp import (
    AllocationProblem,
    AllocationResult,
    TrainerSpec,
    project_current,
)

#: Constraint-skeleton memo (DESIGN.md §11): everything in the aggregate
#: model except the C_j-dependent rescale-indicator rows and the policy
#: objective is a pure function of (|N|, per-Trainer curve/bounds/cap) —
#: so the variable layout, capacity row, Eqn-4 rows and SOS2 blocks are
#: built once per such structure and restored per solve with a flat
#: ``MILPBuilder.clone()``.  The key deliberately excludes ``C_j``,
#: ``t_fwd`` (modulo policy caps), ``r_up``/``r_dw`` and per-job policy
#: fields, which is exactly what drifts event-to-event in a replay.
_SKELETONS: "OrderedDict[Tuple, Tuple]" = OrderedDict()
_SKELETONS_SIZE = 256


def clear_skeleton_cache() -> None:
    _SKELETONS.clear()


def _skeleton(trainers: List[TrainerSpec], n: int, caps: List):
    key = (n, tuple((t.n_min, t.n_max, t.points, t.values, cap)
                    for t, cap in zip(trainers, caps)))
    hit = _SKELETONS.get(key)
    if hit is not None:
        _SKELETONS.move_to_end(key)
        return hit
    j_cnt = len(trainers)
    big_m = n + 1
    b = MILPBuilder()
    n_j = [b.add_var(f"N[{t.id}]", integer=True, lb=0.0, ub=float(t.n_max))
           for t in trainers]
    y_l = b.add_vars("y_l", j_cnt, binary=True)
    z_up = b.add_vars("z_up", j_cnt, binary=True)
    z_dw = b.add_vars("z_dw", j_cnt, binary=True)

    # capacity: sum_j N_j <= |N|
    b.add_row({v: 1.0 for v in n_j}, ub=float(n))

    value_exprs = []
    for ji, t in enumerate(trainers):
        # N_j = 0 or N_min <= N_j (upper bound via var bound).  The
        # relaxation constant must cover n_min even when n_min > |N|
        # (pool transiently smaller than a Trainer's minimum: force
        # N_j = 0, not infeasibility).
        m4 = float(max(big_m, t.n_min))
        b.add_row({n_j[ji]: 1.0, y_l[ji]: m4}, lb=float(t.n_min))
        b.add_row({n_j[ji]: 1.0, y_l[ji]: m4}, ub=m4)
        # policy-imposed hard cap on N_j (e.g. CostCap budgets)
        cap = caps[ji]
        if cap is not None and cap < t.n_max:
            b.add_row({n_j[ji]: 1.0}, ub=float(max(cap, 0)))
        # SOS2 objective metric
        _, value_coeffs = sos2_block(
            b, f"t{t.id}", list(t.points), list(t.values), {n_j[ji]: 1.0})
        value_exprs.append(value_coeffs)

    entry = (b, n_j, z_up, z_dw, value_exprs)
    _SKELETONS[key] = entry
    if len(_SKELETONS) > _SKELETONS_SIZE:
        _SKELETONS.popitem(last=False)
    return entry


def solve_fast_milp(prob: AllocationProblem, *, time_limit: float = 30.0,
                    ) -> AllocationResult:
    """Aggregate (count-based) MILP over the problem's policy objective.

    Identical optimum to ``solve_node_milp`` (see module docstring) at a
    fraction of the variable count.  The objective — Eqn 16 throughput by
    default, or any policy from ``repro_torch.core.objectives`` carried on
    ``prob.objective`` — is built from the same ``JobTerms`` handles as
    the node-level model, so the two stay consistent by construction.

    Assembly is two-phase (DESIGN.md §11): the C_j/policy-independent
    constraint skeleton is cloned from a per-structure memo, then the
    per-event pieces (Eqn-15 rescale rows, policy objective) are appended
    on top.

    Parameters
    ----------
    time_limit : float
        Solver wall-clock limit (seconds); on timeout the §3.6 fallback
        keeps the current map (``fell_back=True``).
    """
    from repro_torch.core.objectives import JobTerms, resolve_objective

    objective = resolve_objective(prob.objective)
    nodes = list(prob.nodes)
    n = len(nodes)
    trainers = prob.trainers
    big_m = n + 1

    current = project_current(prob)
    c_count = {t.id: len(current[t.id]) for t in trainers}

    caps = [objective.count_cap(t, prob.t_fwd) for t in trainers]
    skel, n_j, z_up, z_dw, value_exprs = _skeleton(trainers, n, caps)
    b = skel.clone()

    job_terms = []
    for ji, t in enumerate(trainers):
        cj = float(c_count[t.id])
        # rescale indicators (Eqn 15) — the C_j-dependent rows
        b.add_row({n_j[ji]: 1.0, z_up[ji]: -(big_m - cj)}, ub=cj)
        b.add_row({n_j[ji]: 1.0, z_up[ji]: -(cj + 1.0)}, lb=0.0)
        b.add_row({n_j[ji]: 1.0, z_dw[ji]: big_m - cj + 1.0}, ub=float(big_m))
        b.add_row({n_j[ji]: 1.0, z_dw[ji]: cj}, lb=cj)
        job_terms.append(JobTerms(spec=t, cj=c_count[t.id],
                                  count_expr={n_j[ji]: 1.0},
                                  value_expr=value_exprs[ji],
                                  z_up=z_up[ji], z_dw=z_dw[ji]))

    # policy objective (Eqn 16 by default; see repro_torch.core.objectives)
    obj_offset = objective.build(b, job_terms, prob.t_fwd)
    res = b.solve(maximize=True, time_limit=time_limit)

    if not res.success or res.x is None:
        alloc = {t.id: sorted(current[t.id]) for t in trainers}
        return AllocationResult(
            allocation=alloc,
            counts={t.id: len(alloc[t.id]) for t in trainers},
            objective=None, wall_time=res.wall_time,
            solver_status=res.message, fell_back=True)

    counts = {t.id: int(round(res.x[n_j[ji]]))
              for ji, t in enumerate(trainers)}
    allocation = reconstruct_map(nodes, trainers, current, counts)
    return AllocationResult(allocation=allocation, counts=counts,
                            objective=(res.objective + obj_offset
                                       if res.objective is not None
                                       else None),
                            wall_time=res.wall_time,
                            solver_status=res.message)


def reconstruct_map(nodes: List[int], trainers: List[TrainerSpec],
                    current: Dict[int, List[int]],
                    counts: Dict[int, int]) -> Dict[int, List[int]]:
    """Counts -> concrete node map, keeping current nodes first (so the map
    satisfies the node-level no-migration constraints by construction)."""
    allocation: Dict[int, List[int]] = {}
    used = set()
    for t in trainers:
        keep = sorted(current.get(t.id, []))[: counts.get(t.id, 0)]
        allocation[t.id] = list(keep)
        used.update(keep)
    free = sorted(set(nodes) - used)
    for t in trainers:
        need = counts.get(t.id, 0) - len(allocation[t.id])
        if need > 0:
            take, free = free[:need], free[need:]
            allocation[t.id].extend(take)
            allocation[t.id].sort()
    return allocation
