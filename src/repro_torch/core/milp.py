"""The paper's MILP resource-allocation model (§3), node-level (faithful).

Decision variable ``x_jn ∈ {0,1}``: node n allocated to Trainer j.  On each
event the solver transfers the current map ``c_jn`` into ``x_jn`` to
maximize the problem's policy objective — by default the paper's
Σ_j T_fwd·O_j(N_j) − Σ_j O_j(C_j)·R_j   (Eqn 16), or any
administrator-/user-defined metric from ``repro_torch.core.objectives`` (§3.5's
promised adaptation point) — subject to job-size (Eqn 4),
node-exclusivity (Eqn 5) and no-migration (Eqns 6–10) constraints, with
O_j piecewise-linearized via SOS2 (Eqn 11–12) and rescale costs via
indicator binaries (Eqn 13–15).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.lp import MILPBuilder, sos2_block


@dataclass(frozen=True)
class TrainerSpec:
    """Static description of one Trainer as seen by the allocator.

    Attributes
    ----------
    id : int
        Trainer id (stable across events).
    n_min, n_max : int
        Feasible node-count range (nodes); outside it only ``N_j = 0``
        (the waiting state) is allowed (Eqn 4).
    r_up, r_dw : float
        Scale-up / scale-down stall costs ``R_j^up`` / ``R_j^dw``
        (seconds).
    points, values : tuple
        SOS2 breakpoints (nodes, must include 0) and the objective
        metric ``O_j`` at each (progress units / second).
    weight : float
        Admin priority weight (dimensionless, default 1.0); read by
        :class:`repro_torch.core.objectives.WeightedPriority`.
    deadline : float, optional
        Seconds from *now* until the job's soft deadline; read by
        :class:`repro_torch.core.objectives.DeadlineAware`.
    budget : float, optional
        Node-seconds the job may still consume; read by
        :class:`repro_torch.core.objectives.CostCap`.
    work : float, optional
        Total work in progress units (samples/steps), ``None`` when
        open-ended; normalizes progress-based policies.
    progress : float
        Completed fraction of ``work`` in [0, 1] (0.0 when unknown);
        read by progress-aware policies (max-min fairness, deadlines).
    rate : float, optional
        Offered request rate (requests/second) for serving jobs,
        ``None`` for training jobs; read by
        :class:`repro_torch.core.objectives.LatencySLO`.
    slo : float, optional
        Request-latency SLO target (seconds).  Informational at the
        allocator level (the replica simulation measures attainment);
        excluded from every objective's ``spec_key``.
    """

    id: int
    n_min: int
    n_max: int
    r_up: float                 # scale-up cost, seconds (R_j^up)
    r_dw: float                 # scale-down cost, seconds (R_j^dw)
    points: Tuple[int, ...]     # SOS2 breakpoints (must include 0)
    values: Tuple[float, ...]   # objective metric at each breakpoint
    # per-job policy fields (see repro_torch.core.objectives)
    weight: float = 1.0
    deadline: Optional[float] = None
    budget: Optional[float] = None
    work: Optional[float] = None
    progress: float = 0.0
    rate: Optional[float] = None
    slo: Optional[float] = None

    def value_at(self, n: int) -> float:
        """Interpolated objective metric ``O_j(n)`` (progress units / s)
        at integer node count ``n``."""
        pts, vals = self.points, self.values
        if n <= pts[0]:
            return vals[0]
        if n >= pts[-1]:
            return vals[-1]
        for i in range(len(pts) - 1):
            if pts[i] <= n <= pts[i + 1]:
                t = (n - pts[i]) / (pts[i + 1] - pts[i])
                return vals[i] + t * (vals[i + 1] - vals[i])
        return vals[-1]


@dataclass
class AllocationProblem:
    """One allocation instance: the idle pool, the Trainers, the current
    map, and the policy to optimize.

    Attributes
    ----------
    nodes : list[int]
        Idle node ids (set N).
    trainers : list[TrainerSpec]
        The Trainers competing for nodes (set J).
    current : dict[int, list[int]]
        Current map ``c``: Trainer id -> node ids it holds now.
    t_fwd : float
        Forward-looking time window (seconds, paper §3.4.3).
    racks : dict[int, int], optional
        Topology (paper §7 future work): node id -> rack/switch id.
    objective : Objective | str, optional
        The policy to maximize (repro_torch.core.objectives); ``None`` means
        the paper's Eqn-16 throughput objective.
    """

    nodes: List[int]                       # idle node ids (set N)
    trainers: List[TrainerSpec]            # set J
    current: Dict[int, List[int]]          # c: trainer id -> node ids
    t_fwd: float = 120.0                   # forward-looking time (seconds)
    # optional topology (paper §7 future work): node id -> rack/switch id
    racks: Optional[Dict[int, int]] = None
    # allocation policy (repro_torch.core.objectives); None = Throughput (Eqn 16)
    objective: Optional[object] = None
    # trace-clock time of the event that produced this problem (seconds).
    # Ignored by every solver and by the engine's cache signature; read by
    # time-aware allocator wrappers (repro_torch.chaos.RestartingAllocator's
    # crash/snapshot schedule).
    now: float = 0.0


def project_current(prob: "AllocationProblem") -> Dict[int, List[int]]:
    """Current map restricted to nodes still in the pool (nodes that left
    were preempted; they must not appear in C when transferring state)."""
    node_set = set(prob.nodes)
    return {t.id: [nid for nid in prob.current.get(t.id, [])
                   if nid in node_set] for t in prob.trainers}


@dataclass
class AllocationResult:
    """One solver's answer to an :class:`AllocationProblem`.

    Attributes
    ----------
    allocation : dict[int, list[int]]
        Trainer id -> concrete node ids assigned.
    counts : dict[int, int]
        Trainer id -> node count (``len`` of the above).
    objective : float, optional
        Achieved objective value in the *policy's* units (progress units
        for throughput-style policies, dimensionless for fairness);
        ``None`` for heuristics that do not score, and on fallback.
    wall_time : float
        Solver wall-clock time (seconds).
    solver_status : str
        Human-readable solver outcome.
    fell_back : bool
        True when the §3.6 fallback kept the current map
        (timeout/infeasible).
    """

    allocation: Dict[int, List[int]]       # trainer id -> node ids
    counts: Dict[int, int]
    objective: Optional[float]
    wall_time: float
    solver_status: str
    fell_back: bool = False                # kept current map (timeout/infeasible)


def solve_node_milp(prob: AllocationProblem, *, time_limit: float = 30.0,
                    topo_coef: float = 0.0) -> AllocationResult:
    """Paper-faithful node-level MILP.

    The feasible set is the paper's §3 model (Eqns 4–15); the objective
    is built by the problem's policy (``prob.objective``, default Eqn 16
    throughput — see repro_torch.core.objectives), which may also impose
    per-Trainer count caps.

    With ``topo_coef > 0`` and ``prob.racks`` set, implements the paper's
    §7 future-work item: rack-locality-aware allocation.  Auxiliary
    binaries ``y_jr`` (Trainer j touches rack r) are constrained by
    ``x_jn <= y_j,rack(n)`` and penalized in the objective by
    ``topo_coef · T_fwd · (per-node gain)`` per rack touched — so spreading
    a Trainer across racks must buy at least that much throughput.

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
    node_pos = {nid: i for i, nid in enumerate(nodes)}
    trainers = prob.trainers
    j_cnt = len(trainers)
    big_m = n + 1
    # Eqn 10 needs M > Σx + Σu (up to 2|N|): the paper's "M > |N|" guidance
    # is insufficient there and would silently cap fresh Trainers at |N|/2.
    big_m_mig = 2 * n + 2

    # current map as binary constants (projected to surviving nodes)
    c = np.zeros((j_cnt, n), dtype=int)
    for ji, t in enumerate(trainers):
        for nid in prob.current.get(t.id, []):
            if nid in node_pos:
                c[ji, node_pos[nid]] = 1
    c_count = c.sum(axis=1)

    b = MILPBuilder()
    x = [b.add_vars(f"x[{t.id}]", n, binary=True) for t in trainers]
    u = [b.add_vars(f"u[{t.id}]", n, binary=True) for t in trainers]
    y_l = b.add_vars("y_l", j_cnt, binary=True)
    y_u = b.add_vars("y_u", j_cnt, binary=True)
    z = b.add_vars("z", j_cnt, binary=True)
    z_up = b.add_vars("z_up", j_cnt, binary=True)
    z_dw = b.add_vars("z_dw", j_cnt, binary=True)

    # Eqn 5: node exclusivity
    for ni in range(n):
        b.add_row({x[ji][ni]: 1.0 for ji in range(j_cnt)}, ub=1.0)

    job_terms = []
    for ji, t in enumerate(trainers):
        xr = {v: 1.0 for v in x[ji]}
        cj = float(c_count[ji])

        # policy-imposed hard cap on N_j (e.g. CostCap budgets)
        cap = objective.count_cap(t, prob.t_fwd)
        if cap is not None and cap < t.n_max:
            b.add_row(dict(xr), ub=float(max(cap, 0)))

        # Eqn 4: N_j = 0 or N_min <= N_j <= N_max.  The relaxation
        # constant must cover n_min even when n_min > |N| (a Trainer
        # whose minimum exceeds the current pool — a normal transient
        # in hole harvesting must force N_j = 0, not infeasibility).
        m4 = float(max(big_m, t.n_min))
        b.add_row({**xr, y_l[ji]: m4}, lb=float(t.n_min))
        b.add_row({**xr, y_l[ji]: m4}, ub=m4)
        b.add_row({**xr, y_u[ji]: -big_m}, ub=float(t.n_max))
        b.add_row({**xr, y_u[ji]: big_m}, ub=float(big_m))

        # Eqn 9: u_jn = x_jn XOR c_jn  (c constant)
        for ni in range(n):
            cc = float(c[ji, ni])
            b.add_row({u[ji][ni]: 1.0, x[ji][ni]: -1.0}, ub=cc)      # u<=x+c
            b.add_row({u[ji][ni]: 1.0, x[ji][ni]: -1.0}, lb=-cc)     # u>=x-c
            b.add_row({u[ji][ni]: 1.0, x[ji][ni]: 1.0}, lb=cc)       # u>=c-x
            b.add_row({u[ji][ni]: 1.0, x[ji][ni]: 1.0}, ub=2.0 - cc) # u<=2-x-c
        # Eqn 10: no-migration (|N_j - C_j| = sum u)
        row = dict(xr)
        for v in u[ji]:
            row[v] = row.get(v, 0.0) - 1.0
        row[z[ji]] = big_m_mig
        b.add_row(row, lb=cj)                  # sum x - sum u + M z >= C_j
        row = dict(xr)
        for v in u[ji]:
            row[v] = row.get(v, 0.0) + 1.0
        row[z[ji]] = big_m_mig
        b.add_row(row, ub=cj + big_m_mig)      # sum x + sum u + M z <= C_j + M

        # Eqn 15: rescale indicators
        b.add_row({**xr, z_up[ji]: -(big_m - cj)}, ub=cj)
        b.add_row({**xr, z_up[ji]: -(cj + 1.0)}, lb=0.0)
        b.add_row({**xr, z_dw[ji]: big_m - cj + 1.0}, ub=float(big_m))
        b.add_row({**xr, z_dw[ji]: cj}, lb=cj)

        # Eqn 11/12: SOS2 piecewise objective metric
        _, value_coeffs = sos2_block(
            b, f"t{t.id}", list(t.points), list(t.values), dict(xr))
        job_terms.append(JobTerms(spec=t, cj=int(c_count[ji]),
                                  count_expr=dict(xr),
                                  value_expr=value_coeffs,
                                  z_up=z_up[ji], z_dw=z_dw[ji]))

        # topology extension (paper §7): rack-spread penalty
        if topo_coef > 0.0 and prob.racks is not None:
            rack_ids = sorted({prob.racks[nid] for nid in nodes})
            y_rack = {r: b.add_var(f"yrack[{t.id}][{r}]", binary=True)
                      for r in rack_ids}
            for ni, nid in enumerate(nodes):
                b.add_row({x[ji][ni]: 1.0,
                           y_rack[prob.racks[nid]]: -1.0}, ub=0.0)
            per_node_gain = t.values[-1] / max(t.points[-1], 1)
            for r in rack_ids:
                b.set_obj(y_rack[r],
                          -topo_coef * prob.t_fwd * per_node_gain)

    # policy objective (Eqn 16 by default; see repro_torch.core.objectives)
    obj_offset = objective.build(b, job_terms, prob.t_fwd)
    res = b.solve(maximize=True, time_limit=time_limit)

    if not res.success or res.x is None:
        # §3.6 fallback: keep the current map
        alloc = {j: sorted(ns) for j, ns in project_current(prob).items()}
        return AllocationResult(
            allocation=alloc,
            counts={t.id: len(alloc[t.id]) for t in trainers},
            objective=None, wall_time=res.wall_time,
            solver_status=res.message, fell_back=True)

    xv = res.x
    alloc: Dict[int, List[int]] = {}
    for ji, t in enumerate(trainers):
        alloc[t.id] = sorted(nodes[ni] for ni in range(n)
                             if xv[x[ji][ni]] > 0.5)
    return AllocationResult(
        allocation=alloc,
        counts={t.id: len(v) for t, v in zip(trainers, alloc.values())},
        objective=(res.objective + obj_offset
                   if res.objective is not None else None),
        wall_time=res.wall_time,
        solver_status=res.message)
