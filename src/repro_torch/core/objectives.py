"""Pluggable allocation objectives ("policies") for the BFTrainer MILP.

The paper's abstract promises the MILP "can be adapted to optimize for
administrator- or user-defined metrics" (§3.5); this module is that
adaptation point.  An :class:`Objective` tells every solver in the
portfolio — the node-level MILP (``milp.solve_node_milp``), the aggregate
MILP (``milp_fast.solve_fast_milp``) and the greedy water-filling
heuristic (``greedy.solve_greedy``) — what to maximize, through three
coordinated views of the same function:

* ``build(b, jobs, t_fwd)`` — emit the objective as linear terms (plus any
  auxiliary variables/rows it needs) into a ``MILPBuilder``;
* ``job_value(t, n, cj, t_fwd)`` / ``combine(values)`` — the same
  function as a per-Trainer scalar plus an aggregation, which is what the
  greedy solver's marginal-gain search climbs;
* ``count_cap(t, t_fwd)`` — optional per-Trainer hard cap on the node
  count (used by budget-style policies), applied as a constraint by the
  MILPs and as a target filter by the greedy solver.

Solvers report ``AllocationResult.objective`` in the *policy's* units, so
the engine's best-of-portfolio comparison and the greedy-vs-MILP parity
tests are policy-agnostic.  Memoization safety comes from two more hooks:
``cache_key()`` (the policy's identity + parameters) and ``spec_key(t)``
(exactly the per-Trainer fields this policy reads — see
:func:`repro_torch.core.engine.problem_signature`), so e.g. ``Throughput`` keeps
its high cache-hit rate even though ``TrainerSpec`` now carries progress
and deadline fields it never looks at.

Units used throughout: node counts in nodes, times (``t_fwd``,
``deadline``, ``r_up``/``r_dw``) in seconds, ``budget`` in node-seconds,
throughput ``O_j(N)`` in progress units (samples or steps) per second,
``work`` in progress units, ``progress`` dimensionless in [0, 1].

Adding a sixth policy is documented in DESIGN.md §10.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, TYPE_CHECKING

import numpy as np

from repro_torch.core.lp import MILPBuilder, epigraph_min

if TYPE_CHECKING:  # avoid a runtime cycle: milp.py imports this module
    from repro_torch.core.milp import TrainerSpec

_EPS = 1e-9


@dataclass
class JobTerms:
    """Linear-expression handles for one Trainer inside a MILP build.

    Both MILP formulations (node-level and aggregate) reduce a Trainer to
    the same four handles, so one ``Objective.build`` serves both.

    Attributes
    ----------
    spec : TrainerSpec
        The Trainer's static description (curve breakpoints, costs, and
        the per-job policy fields).
    cj : int
        Current node count ``C_j`` (nodes), after projection onto the
        surviving pool.
    count_expr : dict[int, float]
        Variable -> coefficient expression summing to ``N_j`` (nodes).
    value_expr : dict[int, float]
        Variable -> coefficient expression summing to ``O_j(N_j)``
        (progress units / second), from the SOS2 block.
    z_up, z_dw : int
        Rescale indicator binaries (Eqn 15): 1 iff the Trainer grows /
        shrinks relative to ``cj``.
    """

    spec: "TrainerSpec"
    cj: int
    count_expr: Dict[int, float]
    value_expr: Dict[int, float]
    z_up: int
    z_dw: int


def _rescale_penalty(t: "TrainerSpec", n: int, cj: int) -> float:
    """Foregone progress units for moving Trainer ``t`` from ``cj`` to
    ``n`` nodes: ``O_j(C_j) * R_up`` on grow, ``O_j(C_j) * R_dw`` on
    shrink (paper Eqn 16's cost term)."""
    if n > cj:
        return t.value_at(cj) * t.r_up
    if n < cj:
        return t.value_at(cj) * t.r_dw
    return 0.0


def _eqn16_terms(b: MILPBuilder, jt: JobTerms, t_fwd: float,
                 weight: float = 1.0) -> None:
    """Emit one Trainer's Eqn-16 terms, scaled by ``weight``:
    ``weight * (t_fwd * O_j(N_j) - O_j(C_j) * R_up * z_up
    - O_j(C_j) * R_dw * z_dw)``."""
    for var, coef in jt.value_expr.items():
        b.set_obj(var, weight * t_fwd * coef)
    o_cj = jt.spec.value_at(jt.cj)
    b.set_obj(jt.z_up, -weight * o_cj * jt.spec.r_up)
    b.set_obj(jt.z_dw, -weight * o_cj * jt.spec.r_dw)


# ---------------------------------------------------------------------------
# Vectorized value tables (the greedy/repair hot path, DESIGN.md §11)
# ---------------------------------------------------------------------------


def _interp_table(t: "TrainerSpec", n_hi: int) -> np.ndarray:
    """``O_j(m)`` for m = 0..n_hi as a dense vector (progress units/s),
    linearly interpolated over the SOS2 breakpoints — the vectorized
    counterpart of ``TrainerSpec.value_at``."""
    ns = np.arange(n_hi + 1, dtype=float)
    return np.interp(ns, np.asarray(t.points, dtype=float),
                     np.asarray(t.values, dtype=float))


def _penalty_table(t: "TrainerSpec", cj: int, n_hi: int) -> np.ndarray:
    """``rescale_penalty(t, m, cj)`` for m = 0..n_hi as a dense vector."""
    o_cj = t.value_at(cj)
    pen = np.zeros(n_hi + 1)
    if cj < n_hi:
        pen[cj + 1:] = o_cj * t.r_up
    if cj > 0:
        pen[:min(cj, n_hi + 1)] = o_cj * t.r_dw
    return pen


#: module-level LRU of materialized value tables.  Keys are id-free (the
#: policy's own cache_key/spec_key plus the Trainer's curve/cost fields),
#: so tables are shared across events exactly when the engine's
#: memoization signature would match that Trainer — one materialization
#: per engine signature (for the vectorized greedy solver).
_VT_CACHE: "OrderedDict[Tuple, np.ndarray]" = OrderedDict()
_VT_CACHE_SIZE = 4096


def cached_value_table(objective: "Objective", t: "TrainerSpec", cj: int,
                       t_fwd: float) -> np.ndarray:
    """Memoized ``objective.value_table(t, cj, t_fwd)`` (read-only array)."""
    key = (objective.cache_key(), objective.spec_key(t), t.n_min, t.n_max,
           t.r_up, t.r_dw, t.points, t.values, cj, t_fwd)
    tab = _VT_CACHE.get(key)
    if tab is not None:
        _VT_CACHE.move_to_end(key)
        return tab
    tab = np.asarray(objective.value_table(t, cj, t_fwd), dtype=float)
    tab.setflags(write=False)
    _VT_CACHE[key] = tab
    if len(_VT_CACHE) > _VT_CACHE_SIZE:
        _VT_CACHE.popitem(last=False)
    return tab


def clear_value_table_cache() -> None:
    _VT_CACHE.clear()


def _feasible_hull(tab: np.ndarray, n_min: int, hi: int):
    """Upper concave hull of ``tab`` over the feasible counts
    ``{0} ∪ [n_min, hi]``.

    Returns ``(base, slopes, widths)``: the hull value at 0 plus the
    hull's segments left-to-right (slopes strictly decreasing).  Any
    feasible ``v(m)`` satisfies ``v(m) <= base + Σ`` of the first ``m``
    node-widths of segments, which is what makes the water-filling
    relaxation below a true upper bound.
    """
    if hi < n_min:
        return float(tab[0]), np.empty(0), np.empty(0)
    idx = np.concatenate(([0], np.arange(n_min, hi + 1)))
    ys = tab[idx]
    hull: List[Tuple[int, float]] = []
    for x, y in zip(idx.tolist(), ys.tolist()):
        while len(hull) >= 2:
            (x1, y1), (x2, y2) = hull[-2], hull[-1]
            if (y2 - y1) * (x - x2) <= (y - y2) * (x2 - x1):
                hull.pop()          # middle vertex under the chord
            else:
                break
        hull.append((x, y))
    xs = np.array([p[0] for p in hull], dtype=float)
    vs = np.array([p[1] for p in hull], dtype=float)
    slopes = np.diff(vs) / np.diff(xs)
    widths = np.diff(xs)
    keep = slopes > 0.0             # a maximizer never takes a downhill segment
    return float(vs[0]), slopes[keep], widths[keep]


class Objective:
    """Base policy: what the allocation portfolio maximizes.

    Subclasses implement the three coordinated views documented in the
    module docstring.  ``separable=True`` declares that the total
    objective is ``sum(job_value(...))`` — the greedy solver then uses
    exact per-Trainer deltas (and is bit-for-bit identical to the
    historical single-objective code path for :class:`Throughput`);
    non-separable policies are climbed through ``combine``.
    """

    name = "base"
    #: True iff combine(values) == sum(values); enables the greedy fast path.
    separable = True

    # -- identity (memoization) ----------------------------------------

    def cache_key(self) -> Tuple:
        """Hashable identity of the policy *and its parameters*; part of
        the engine's memoization signature."""
        return (self.name,)

    def spec_key(self, t: "TrainerSpec") -> Tuple:
        """The per-Trainer policy fields this objective actually reads
        (beyond the base curve/cost fields, which are always keyed).
        Conservative default: all of them."""
        return (round(t.weight, 9),
                None if t.deadline is None else round(t.deadline, 9),
                None if t.budget is None else round(t.budget, 9),
                None if t.work is None else round(t.work, 9),
                round(t.progress, 9),
                None if t.rate is None else round(t.rate, 9),
                None if t.slo is None else round(t.slo, 9))

    # -- constraints ----------------------------------------------------

    def count_cap(self, t: "TrainerSpec", t_fwd: float) -> Optional[int]:
        """Optional hard upper bound on ``N_j`` (nodes) this policy
        imposes, or ``None``.  A cap below ``n_min`` forces ``N_j = 0``."""
        return None

    # -- greedy view ----------------------------------------------------

    def job_value(self, t: "TrainerSpec", n: int, cj: int,
                  t_fwd: float) -> float:
        """Per-Trainer scalar value of holding ``n`` nodes for the next
        ``t_fwd`` seconds, in the policy's objective units."""
        raise NotImplementedError

    def value_table(self, t: "TrainerSpec", cj: int,
                    t_fwd: float) -> np.ndarray:
        """Dense per-Trainer value vector ``[job_value(t, m, cj, t_fwd)
        for m in 0..n_max]``.

        The base implementation loops ``job_value`` (always correct);
        the built-in policies override it with closed-form numpy so the
        vectorized greedy/repair path materializes tables in O(n_max)
        numpy time.  Overrides must agree with ``job_value`` to float
        interpolation accuracy (parity-tested in tests/test_engine.py).
        """
        return np.array([self.job_value(t, m, cj, t_fwd)
                         for m in range(t.n_max + 1)], dtype=float)

    def upper_bound(self, trainers: Sequence["TrainerSpec"],
                    cjs: Sequence[int], n_nodes: int,
                    t_fwd: float) -> Optional[float]:
        """Cheap upper bound on the optimal objective, or ``None``.

        Used by the engine's incremental re-solve to decide whether a
        warm-start repair is good enough or must escalate (DESIGN.md
        §11).  The separable default relaxes the problem to its upper
        concave envelope and water-fills ``n_nodes`` fractionally over
        the merged hull segments — a classic LP-style bound, exact when
        every value curve is concave.  Returns ``None`` when no cheap
        bound exists (non-separable policies without an override), which
        makes the engine always escalate — conservative, never wrong.
        """
        if not self.separable:
            return None
        base = 0.0
        seg_s: List[np.ndarray] = []
        seg_w: List[np.ndarray] = []
        for t, cj in zip(trainers, cjs):
            cap = self.count_cap(t, t_fwd)
            hi = t.n_max if cap is None else min(t.n_max, cap)
            b, s, w = _feasible_hull(cached_value_table(self, t, cj, t_fwd),
                                     t.n_min, hi)
            base += b
            seg_s.append(s)
            seg_w.append(w)
        slopes = np.concatenate(seg_s) if seg_s else np.empty(0)
        widths = np.concatenate(seg_w) if seg_w else np.empty(0)
        if not len(slopes):
            return base
        order = np.argsort(-slopes)
        slopes, widths = slopes[order], widths[order]
        take = np.minimum(widths,
                          np.maximum(0.0, n_nodes - (np.cumsum(widths)
                                                     - widths)))
        return base + float(np.dot(slopes, take))

    def combine(self, values: Sequence[float],
                trainers: Optional[Sequence["TrainerSpec"]] = None) -> float:
        """Aggregate per-Trainer values into the scalar objective.

        ``trainers`` is the spec list parallel to ``values``; separable
        policies ignore it, non-separable ones may read per-job
        constants (e.g. progress ranks) from it.
        """
        return float(sum(values))

    def combiner(self, trainers: Sequence["TrainerSpec"]):
        """Bind ``combine`` to a fixed Trainer list for a whole solve.

        The greedy solver evaluates thousands of candidate moves against
        one unchanging Trainer set; policies whose aggregation needs
        per-instance constants (e.g. max-min's progress ranks) override
        this to precompute them once instead of per ``combine`` call.
        """
        return lambda values: self.combine(values, trainers)

    def move_evaluator(self, trainers: Sequence["TrainerSpec"]):
        """Bind an exact move-gain evaluator for the greedy solver.

        Returns ``f(vals, changes) -> gain`` where ``changes`` is a list
        of ``(index, new_value)`` pairs and ``gain`` is any totally
        ordered improvement measure (floats and tuples both work; zero
        gain is ``f(vals, [])``).  The default — the summed value delta —
        is exact for separable policies.  Non-separable policies override
        this rather than relying on ``combine(new) - combine(old)``,
        whose floating-point cancellation silently zeroes out gain
        components much smaller than the aggregate (e.g. deep-rank
        leximin tiebreaks).
        """
        def f(vals, changes):
            return sum(v - vals[i] for i, v in changes)
        return f

    # -- MILP view -------------------------------------------------------

    def build(self, b: MILPBuilder, jobs: List[JobTerms],
              t_fwd: float) -> float:
        """Emit objective terms (and any auxiliary vars/rows) into ``b``.

        Returns a constant offset to add to the solver's reported
        objective so it matches ``combine([job_value(...)])`` exactly
        (MILP objectives cannot carry constants).
        """
        raise NotImplementedError


class Throughput(Objective):
    """The paper's Eqn 16 (default): maximize forward-looking progress
    ``sum_j t_fwd * O_j(N_j)`` minus rescale costs.  Reproduces the
    pre-policy allocator bit-for-bit."""

    name = "throughput"

    def spec_key(self, t: "TrainerSpec") -> Tuple:
        return ()                     # reads no per-job policy fields

    def job_value(self, t, n, cj, t_fwd):
        return t_fwd * t.value_at(n) - _rescale_penalty(t, n, cj)

    def value_table(self, t, cj, t_fwd):
        return (t_fwd * _interp_table(t, t.n_max)
                - _penalty_table(t, cj, t.n_max))

    def build(self, b, jobs, t_fwd):
        for jt in jobs:
            _eqn16_terms(b, jt, t_fwd)
        return 0.0


class WeightedPriority(Objective):
    """Admin-weighted throughput: ``sum_j w_j * (Eqn 16 term)_j``.

    Weights resolve per Trainer as ``weights[id]`` if an explicit mapping
    was given, else the Trainer's own ``spec.weight`` (default 1.0 —
    identical to :class:`Throughput`).  A Trainer with weight 2 buys nodes
    at half the marginal price of a weight-1 Trainer; weight <= 0 removes
    a job from the allocation entirely — ``count_cap`` pins it to 0
    nodes (an objective coefficient of 0 alone would leave the MILPs
    *indifferent*, free to park surplus nodes on the job and charge it
    real rescale stalls the admin zeroed it out to avoid).

    Parameters
    ----------
    weights : mapping[int, float], optional
        Admin-side override: Trainer id -> weight.  Ids absent from the
        mapping fall back to ``spec.weight``.
    """

    name = "weighted"

    def __init__(self, weights: Optional[Mapping[int, float]] = None):
        self.weights = dict(weights) if weights else None

    def _weight(self, t: "TrainerSpec") -> float:
        if self.weights is not None and t.id in self.weights:
            return float(self.weights[t.id])
        return float(t.weight)

    def cache_key(self):
        w = (tuple(sorted(self.weights.items()))
             if self.weights is not None else None)
        return (self.name, w)

    def spec_key(self, t):
        return (round(self._weight(t), 9),)

    def count_cap(self, t, t_fwd):
        # weight <= 0: pin to zero nodes, don't leave the solver indifferent
        return 0 if self._weight(t) <= 0.0 else None

    def job_value(self, t, n, cj, t_fwd):
        return self._weight(t) * (
            t_fwd * t.value_at(n) - _rescale_penalty(t, n, cj))

    def value_table(self, t, cj, t_fwd):
        return self._weight(t) * (t_fwd * _interp_table(t, t.n_max)
                                  - _penalty_table(t, cj, t.n_max))

    def build(self, b, jobs, t_fwd):
        for jt in jobs:
            _eqn16_terms(b, jt, t_fwd, weight=self._weight(jt.spec))
        return 0.0


def _norm_denom(t: "TrainerSpec", t_fwd: float) -> float:
    """Progress-unit denominator normalizing one forward window: the
    Trainer's total ``work`` when known, else ``t_fwd * O_j(n_max)`` (so
    open-ended jobs are scored by normalized rate instead)."""
    if t.work is not None and t.work > 0:
        return float(t.work)
    return max(t_fwd * t.value_at(t.n_max), _EPS)


class MaxMinFairness(Objective):
    """Max-min fairness over projected normalized progress.

    Each Trainer's score is its *projected normalized progress* at the
    end of the forward window (dimensionless):

        p_j(N) = progress_j + (t_fwd * O_j(N) - rescale_penalty_j(N)) / D_j

    with ``D_j = work_j`` (or ``t_fwd * O_j(n_max)`` for open-ended jobs,
    reducing p_j to a normalized rate).  The objective is

        max  min_j p_j(N_j)  +  sum_j kappa_j * p_j(N_j)

    where the min is linearized with an epigraph variable
    ``f <= p_j(N_j)`` for every j (``lp.epigraph_min``) and the
    ``kappa_j`` are *leximin tiebreak* constants: jobs ranked by current
    progress (lowest first, ties by id) get geometrically decaying
    weights ``kappa_j = tiebreak^(rank_j + 1)``.  The plain epigraph
    alone goes blind whenever some job must receive zero nodes (the min
    is then pinned at that job's progress, and a uniform tiebreak would
    collapse back to throughput — starving slow-scaling DNNs forever);
    the rank-weighted tiebreak approximates leximin instead: whatever
    nodes cannot raise the minimum go preferentially to the
    furthest-behind job that *can* use them.  Ranks are constants at
    solve time, so the MILP stays linear and the greedy climbs the
    identical function through ``combine`` (DESIGN.md §10).

    Because ``progress_j`` enters both the score and the ranks, a job
    starved at one event attracts nodes at the next — the policy
    equalizes *accumulated* progress over a trace, not just
    instantaneous rates (tested in tests/test_objectives.py).

    Parameters
    ----------
    tiebreak : float
        Base of the rank-decayed tiebreak weights (dimensionless,
        default 1e-2; keep << 1 so the true minimum dominates).
    """

    name = "maxmin"
    separable = False

    def __init__(self, tiebreak: float = 1e-2):
        self.tiebreak = float(tiebreak)

    def cache_key(self):
        return (self.name, round(self.tiebreak, 12))

    def spec_key(self, t):
        return (None if t.work is None else round(t.work, 9),
                round(t.progress, 9))

    def _kappas(self, trainers: Sequence["TrainerSpec"]) -> List[float]:
        """Leximin tiebreak weights, parallel to ``trainers``: rank by
        progress ascending, weight ``tiebreak^(rank+1)``.

        Progress ties break on the full spec *content* (curve, bounds,
        costs, weight, work) rather than on Trainer id: the engine's
        memoization signature is id-free, so the rank assignment must be
        too — trainers that still tie after the content key are fully
        interchangeable and the final id tiebreak is harmless.
        """
        def key(t: "TrainerSpec"):
            return (t.progress, t.n_min, t.n_max, t.points, t.values,
                    t.r_up, t.r_dw, t.weight,
                    t.work if t.work is not None else -1.0, t.id)

        order = sorted(range(len(trainers)), key=lambda i: key(trainers[i]))
        kap = [0.0] * len(trainers)
        for rank, i in enumerate(order):
            kap[i] = self.tiebreak ** (rank + 1)
        return kap

    def job_value(self, t, n, cj, t_fwd):
        d = _norm_denom(t, t_fwd)
        return t.progress + (t_fwd * t.value_at(n)
                             - _rescale_penalty(t, n, cj)) / d

    def value_table(self, t, cj, t_fwd):
        d = _norm_denom(t, t_fwd)
        return t.progress + (t_fwd * _interp_table(t, t.n_max)
                             - _penalty_table(t, cj, t.n_max)) / d

    def upper_bound(self, trainers, cjs, n_nodes, t_fwd):
        """``max min_j p_j <= min_j max_m p_j(m)`` plus the maximal
        tiebreak term — loose (it ignores the shared-pool coupling), so
        maxmin repairs usually escalate; correctness over speed here."""
        if not trainers:
            return 0.0
        kap = self._kappas(trainers)
        maxes = []
        for t, cj in zip(trainers, cjs):
            tab = cached_value_table(self, t, cj, t_fwd)
            feas = np.concatenate(([tab[0]], tab[t.n_min:]))
            maxes.append(float(feas.max()))
        return float(min(maxes)) + sum(k * m for k, m in zip(kap, maxes))

    def combine(self, values, trainers=None):
        if not values:
            return 0.0
        if trainers is None:
            raise ValueError(
                "MaxMinFairness.combine needs the trainers list: the "
                "leximin tiebreak weights are derived from per-Trainer "
                "progress ranks")
        kap = self._kappas(trainers)
        return float(min(values)) + sum(k * v for k, v in zip(kap, values))

    def combiner(self, trainers):
        kap = self._kappas(trainers)    # ranks are solve-time constants

        def combine(values):
            if not values:
                return 0.0
            return (float(min(values))
                    + sum(k * v for k, v in zip(kap, values)))
        return combine

    def move_evaluator(self, trainers):
        """Lexicographic (Δmin, Δtiebreak) move gains.

        Both components are computed as *exact deltas*: Δtiebreak is
        ``Σ κ_i·(v_new − v_old)`` over only the changed entries, never
        ``combine(new) − combine(old)`` — a κ of ``tiebreak^9 ≈ 1e-18``
        is far below one ulp of the O(1) aggregate, so the subtraction
        form would round deep-rank gains to exactly 0 and re-starve the
        jobs the policy protects.  Comparing ``(Δmin, Δtiebreak)``
        tuples makes any true lift of the minimum dominate and keeps
        arbitrarily deep tiebreak gains ordered correctly.
        """
        kap = self._kappas(trainers)

        def f(vals, changes):
            if not changes:
                return (0.0, 0.0)
            old_min = min(vals)
            changed = dict(changes)
            new_min = min(changed.get(i, v) for i, v in enumerate(vals))
            d_tie = sum(kap[i] * (v - vals[i]) for i, v in changes)
            return (new_min - old_min, d_tie)
        return f

    def build(self, b, jobs, t_fwd):
        if not jobs:
            return 0.0
        exprs = []
        offset = 0.0
        kappas = self._kappas([jt.spec for jt in jobs])
        for jt, kap in zip(jobs, kappas):
            t = jt.spec
            d = _norm_denom(t, t_fwd)
            o_cj = t.value_at(jt.cj)
            # p_j(N_j) = progress_j + (t_fwd*O - pen_up*z_up - pen_dw*z_dw)/d
            coeffs = {var: t_fwd * coef / d
                      for var, coef in jt.value_expr.items()}
            coeffs[jt.z_up] = coeffs.get(jt.z_up, 0.0) - o_cj * t.r_up / d
            coeffs[jt.z_dw] = coeffs.get(jt.z_dw, 0.0) - o_cj * t.r_dw / d
            exprs.append((float(t.progress), coeffs))
            # leximin tiebreak: kappa_j * p_j
            for var, coef in coeffs.items():
                b.set_obj(var, kap * coef)
            offset += kap * float(t.progress)
        f = epigraph_min(b, "f_minprog", exprs)
        b.set_obj(f, 1.0)
        return offset


class DeadlineAware(Objective):
    """Throughput with a soft-deadline penalty on projected finish time.

    A Trainer with ``deadline`` (seconds from now) and known remaining
    work ``(1 - progress) * work`` finishes by its deadline iff its rate
    clears the *required rate*

        req_j = (1 - progress_j) * work_j / max(deadline_j, eps)

    (progress units / second) — so "projected finish <= deadline" is the
    linear condition ``O_j(N_j) >= req_j``, and the soft penalty is the
    hinge ``penalty_weight * t_fwd * max(0, req_j - O_j(N_j))``
    subtracted from the Eqn-16 objective.  In the MILPs the hinge is one
    slack variable ``s_j >= req_j - O_j(N_j), s_j >= 0`` per deadlined
    Trainer.  ``req_j`` is clamped to ``2 * O_j(n_max)``: a deadline that
    is already unreachable contributes a bounded (sunk) penalty instead
    of drowning the objective.  Trainers with no deadline (or unknown
    work) score plain throughput.

    Parameters
    ----------
    penalty_weight : float
        Progress units charged per unit of rate shortfall per forward
        window, relative to throughput gain (dimensionless, default 2.0:
        missing deadlines costs twice what raw throughput buys).
    """

    name = "deadline"

    def __init__(self, penalty_weight: float = 2.0):
        self.penalty_weight = float(penalty_weight)

    def cache_key(self):
        return (self.name, round(self.penalty_weight, 12))

    def spec_key(self, t):
        return (None if t.deadline is None else round(t.deadline, 9),
                None if t.work is None else round(t.work, 9),
                round(t.progress, 9))

    def _req_rate(self, t: "TrainerSpec") -> Optional[float]:
        """Required rate (progress units/s) to finish by the deadline, or
        ``None`` when no deadline applies."""
        if t.deadline is None or t.work is None or t.work <= 0:
            return None
        remaining = max(0.0, (1.0 - t.progress) * t.work)
        if remaining <= 0:
            return None
        req = remaining / max(float(t.deadline), _EPS)
        return min(req, 2.0 * t.value_at(t.n_max))

    def job_value(self, t, n, cj, t_fwd):
        v = t_fwd * t.value_at(n) - _rescale_penalty(t, n, cj)
        req = self._req_rate(t)
        if req is not None:
            v -= self.penalty_weight * t_fwd * max(0.0, req - t.value_at(n))
        return v

    def value_table(self, t, cj, t_fwd):
        o = _interp_table(t, t.n_max)
        v = t_fwd * o - _penalty_table(t, cj, t.n_max)
        req = self._req_rate(t)
        if req is not None:
            v = v - self.penalty_weight * t_fwd * np.maximum(0.0, req - o)
        return v

    def build(self, b, jobs, t_fwd):
        for jt in jobs:
            _eqn16_terms(b, jt, t_fwd)
            req = self._req_rate(jt.spec)
            if req is None:
                continue
            # hinge slack: s >= req - O(N), s >= 0
            s = b.add_var(f"dl_slack[{jt.spec.id}]", lb=0.0, ub=float("inf"))
            row = {s: 1.0}
            for var, coef in jt.value_expr.items():
                row[var] = row.get(var, 0.0) + coef
            b.add_row(row, lb=req)
            b.set_obj(s, -self.penalty_weight * t_fwd)
        return 0.0


class CostCap(Throughput):
    """Throughput under a per-job node-second budget.

    A Trainer with ``budget`` node-seconds remaining may hold at most
    ``floor(budget / t_fwd)`` nodes over the next forward window — spend
    rate capped so the budget survives the window; below ``n_min`` the
    Trainer must idle.  The cap is a hard constraint (MILP row /
    greedy target filter), the objective is plain Eqn 16.  Budgets are
    enforced at decision points only: between sparse pool events a
    Trainer keeps its allocation, so enforcement granularity is
    ``max(t_fwd, inter-event gap)`` (DESIGN.md §10).

    Parameters
    ----------
    default_budget : float, optional
        Node-seconds applied to Trainers whose spec carries no budget
        (``None`` = such Trainers are uncapped).
    """

    name = "costcap"

    def __init__(self, default_budget: Optional[float] = None):
        self.default_budget = default_budget

    def cache_key(self):
        return (self.name,
                None if self.default_budget is None
                else round(self.default_budget, 9))

    def spec_key(self, t):
        return (None if t.budget is None else round(t.budget, 9),)

    def count_cap(self, t, t_fwd):
        budget = t.budget if t.budget is not None else self.default_budget
        if budget is None:
            return None
        cap = int(max(0.0, float(budget)) // max(float(t_fwd), _EPS))
        return cap if cap >= t.n_min else 0


class LatencySLO(Objective):
    """SLO-attainment-weighted goodput for elastic serving Trainers.

    A serving Trainer advertises its *offered request rate* via
    ``spec.rate`` (requests/second, measured over a trailing window by
    :class:`repro_torch.core.backend.ServingBackend`).  Requests served beyond
    the offered load are worthless (nobody is asking), and capacity
    shortfall is what queues requests past their latency SLO — so the
    per-Trainer value saturates at the *required capacity*

        req_j = headroom * rate_j      (requests / second)

    and shortfall below it is charged ``miss_weight`` times what surplus
    capacity earns:

        v_j(N) = t_fwd * (min(O_j, req_j) - miss_weight * max(0, req_j - O_j)
                          + tie_eps * O_j) - rescale_penalty

    where ``O_j = O_j(N_j)`` is the replica capacity curve
    (requests/second at N nodes).  ``headroom`` buys queueing slack: a
    replica running exactly at the arrival rate has unbounded queues
    (utilization 1), so the policy provisions ``headroom``× the offered
    load, which is what keeps p99 latency under the SLO.  ``req_j`` is
    clamped to ``2 * O_j(n_max)`` exactly like
    :class:`DeadlineAware`: unreachable demand contributes a bounded
    (sunk) penalty instead of drowning the objective.  ``tie_eps`` adds a
    vanishing throughput slope past saturation so the MILP is never
    indifferent between node counts the saturated term cannot separate
    (and the greedy/MILP views stay in exact parity — both include it).

    Trainers with ``rate is None`` (training jobs sharing the pool)
    score the plain Eqn-16 throughput objective, so mixed
    serving+training pools work out of the box.  ``spec.slo`` (the
    latency target itself) is *not* read here — attainment against it is
    measured by the replica simulation (``repro_torch.serving``); the
    allocator only sees its capacity-rate proxy.

    In the MILPs the saturating hinge is one slack variable per serving
    Trainer, via the identity (``s_j = max(0, req_j - O_j)``):

        min(O_j, req_j) - miss_weight * max(0, req_j - O_j)
            = req_j - (1 + miss_weight) * s_j

    with ``s_j >= req_j - O_j(N_j), s_j >= 0`` and the constant
    ``t_fwd * req_j`` returned as the build offset.

    Parameters
    ----------
    headroom : float
        Capacity provisioned per unit of offered load (dimensionless,
        default 1.25 — 25% queueing slack).
    miss_weight : float
        Penalty per unit of capacity shortfall relative to what surplus
        earns (dimensionless, default 4.0: an under-provisioned replica
        outbids any tie_eps surplus elsewhere).
    tie_eps : float
        Residual throughput slope past saturation (dimensionless,
        default 1e-6).
    """

    name = "latency_slo"

    def __init__(self, headroom: float = 1.25, miss_weight: float = 4.0,
                 tie_eps: float = 1e-6):
        self.headroom = float(headroom)
        self.miss_weight = float(miss_weight)
        self.tie_eps = float(tie_eps)

    def cache_key(self):
        return (self.name, round(self.headroom, 12),
                round(self.miss_weight, 12), round(self.tie_eps, 12))

    def spec_key(self, t):
        return (None if t.rate is None else round(t.rate, 9),)

    def _req_rate(self, t: "TrainerSpec") -> Optional[float]:
        """Required capacity (requests/s) for Trainer ``t``, or ``None``
        when it is not a serving job."""
        if t.rate is None:
            return None
        req = self.headroom * max(0.0, float(t.rate))
        return min(req, 2.0 * t.value_at(t.n_max))

    def job_value(self, t, n, cj, t_fwd):
        o = t.value_at(n)
        req = self._req_rate(t)
        if req is None:
            return t_fwd * o - _rescale_penalty(t, n, cj)
        v = (min(o, req) - self.miss_weight * max(0.0, req - o)
             + self.tie_eps * o)
        return t_fwd * v - _rescale_penalty(t, n, cj)

    def value_table(self, t, cj, t_fwd):
        o = _interp_table(t, t.n_max)
        pen = _penalty_table(t, cj, t.n_max)
        req = self._req_rate(t)
        if req is None:
            return t_fwd * o - pen
        v = (np.minimum(o, req)
             - self.miss_weight * np.maximum(0.0, req - o)
             + self.tie_eps * o)
        return t_fwd * v - pen

    def build(self, b, jobs, t_fwd):
        offset = 0.0
        for jt in jobs:
            req = self._req_rate(jt.spec)
            if req is None:
                _eqn16_terms(b, jt, t_fwd)
                continue
            # rescale-cost terms, identical to Eqn 16's
            o_cj = jt.spec.value_at(jt.cj)
            b.set_obj(jt.z_up, -o_cj * jt.spec.r_up)
            b.set_obj(jt.z_dw, -o_cj * jt.spec.r_dw)
            # saturating hinge: s >= req - O(N), s >= 0, objective
            # t_fwd * (req - (1 + miss_weight) * s + tie_eps * O(N))
            s = b.add_var(f"slo_slack[{jt.spec.id}]", lb=0.0,
                          ub=float("inf"))
            row = {s: 1.0}
            for var, coef in jt.value_expr.items():
                row[var] = row.get(var, 0.0) + coef
            b.add_row(row, lb=req)
            b.set_obj(s, -(1.0 + self.miss_weight) * t_fwd)
            for var, coef in jt.value_expr.items():
                b.set_obj(var, self.tie_eps * t_fwd * coef)
            offset += t_fwd * req
        return offset


#: Registry of named policies (string -> zero-arg constructor); strings
#: are accepted anywhere an Objective is (``resolve_objective``).
OBJECTIVES = {
    "throughput": Throughput,
    "weighted": WeightedPriority,
    "maxmin": MaxMinFairness,
    "deadline": DeadlineAware,
    "costcap": CostCap,
    "latency_slo": LatencySLO,
}


def resolve_objective(obj) -> Objective:
    """Coerce ``None`` (-> :class:`Throughput`), a registry name, or an
    :class:`Objective` instance into an instance.

    Raises ``KeyError`` for unknown names and ``TypeError`` for anything
    else.
    """
    if obj is None:
        return Throughput()
    if isinstance(obj, Objective):
        return obj
    if isinstance(obj, str):
        try:
            return OBJECTIVES[obj]()
        except KeyError:
            raise KeyError(f"unknown objective {obj!r}; "
                           f"available: {sorted(OBJECTIVES)}") from None
    raise TypeError(f"objective must be None, a name or an Objective, "
                    f"got {type(obj).__name__}")
