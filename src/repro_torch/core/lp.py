"""Tiny sparse MILP assembly layer over scipy.optimize.milp (HiGHS).

The paper solves its model with Gurobi; HiGHS is an exact branch-and-cut
MILP solver, so optimal objective values are solver-independent.

Constraint storage is COO-direct: ``add_row`` appends straight onto flat
``(data, row, col)`` triplet lists, so ``solve`` assembles the sparse
matrix without re-walking per-row dicts — and ``clone()`` is a handful
of C-speed list copies, which is what makes the per-signature constraint
skeleton cache in ``milp_fast`` cheap (DESIGN.md §11).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.optimize import Bounds, LinearConstraint, milp


@dataclass
class MILPBuilder:
    n_vars: int = 0
    names: List[str] = field(default_factory=list)
    integrality: List[int] = field(default_factory=list)
    lb: List[float] = field(default_factory=list)
    ub: List[float] = field(default_factory=list)
    obj: Dict[int, float] = field(default_factory=dict)
    n_rows: int = 0
    row_lb: List[float] = field(default_factory=list)
    row_ub: List[float] = field(default_factory=list)
    # constraint matrix as flat COO triplets (parallel lists)
    coo_data: List[float] = field(default_factory=list)
    coo_row: List[int] = field(default_factory=list)
    coo_col: List[int] = field(default_factory=list)

    def add_var(self, name: str, *, binary: bool = False, integer: bool = False,
                lb: float = 0.0, ub: float = 1.0) -> int:
        idx = self.n_vars
        self.n_vars += 1
        self.names.append(name)
        self.integrality.append(1 if (binary or integer) else 0)
        self.lb.append(0.0 if binary else lb)
        self.ub.append(1.0 if binary else ub)
        return idx

    def add_vars(self, prefix: str, n: int, **kw) -> List[int]:
        return [self.add_var(f"{prefix}[{i}]", **kw) for i in range(n)]

    def set_obj(self, idx: int, coef: float) -> None:
        self.obj[idx] = self.obj.get(idx, 0.0) + coef

    def add_row(self, coeffs: Dict[int, float], lb: float = -np.inf,
                ub: float = np.inf) -> None:
        r = self.n_rows
        self.n_rows += 1
        self.coo_row.extend([r] * len(coeffs))
        self.coo_col.extend(coeffs.keys())
        self.coo_data.extend(coeffs.values())
        self.row_lb.append(lb)
        self.row_ub.append(ub)

    def clone(self) -> "MILPBuilder":
        """Independent copy — the skeleton-cache restore path: flat list
        copies only, no per-row dict rebuilding."""
        return MILPBuilder(
            n_vars=self.n_vars, names=list(self.names),
            integrality=list(self.integrality),
            lb=list(self.lb), ub=list(self.ub), obj=dict(self.obj),
            n_rows=self.n_rows, row_lb=list(self.row_lb),
            row_ub=list(self.row_ub), coo_data=list(self.coo_data),
            coo_row=list(self.coo_row), coo_col=list(self.coo_col))

    # ------------------------------------------------------------------

    def solve(self, *, maximize: bool = True, time_limit: float = 30.0,
              mip_rel_gap: float = 1e-6):
        c = np.zeros(self.n_vars)
        for i, v in self.obj.items():
            c[i] = -v if maximize else v

        a = sp.csr_matrix((self.coo_data, (self.coo_row, self.coo_col)),
                          shape=(self.n_rows, self.n_vars))
        cons = LinearConstraint(a, np.array(self.row_lb), np.array(self.row_ub))
        t0 = time.perf_counter()
        res = milp(
            c,
            constraints=[cons],
            integrality=np.array(self.integrality),
            bounds=Bounds(np.array(self.lb), np.array(self.ub)),
            options={"time_limit": time_limit, "mip_rel_gap": mip_rel_gap,
                     "disp": False},
        )
        wall = time.perf_counter() - t0
        value = (-res.fun if maximize else res.fun) if res.x is not None else None
        return MILPResult(status=int(res.status), success=bool(res.success),
                          x=res.x, objective=value, wall_time=wall,
                          message=str(res.message))


@dataclass
class MILPResult:
    status: int
    success: bool
    x: Optional[np.ndarray]
    objective: Optional[float]
    wall_time: float
    message: str = ""


def epigraph_min(b: MILPBuilder, name: str,
                 exprs: List[Tuple[float, Dict[int, float]]]) -> int:
    """Append an epigraph variable ``f = min_i (const_i + coeffs_i · x)``.

    The standard linearization of maximizing a minimum: a free continuous
    variable ``f`` with one row ``f <= const_i + coeffs_i · x`` per
    expression.  ``f`` equals the min only at optimality of a maximize
    objective that rewards ``f`` — callers must put a positive objective
    coefficient on the returned variable.

    Parameters
    ----------
    exprs : list of (const, coeffs)
        Each expression is a constant plus a sparse linear form
        (variable index -> coefficient).

    Returns
    -------
    int
        The index of the epigraph variable ``f``.
    """
    f = b.add_var(name, lb=-np.inf, ub=np.inf)
    for const, coeffs in exprs:
        row = {f: 1.0}
        for v, cf in coeffs.items():
            row[v] = row.get(v, 0.0) - cf
        b.add_row(row, ub=const)
    return f


def sos2_block(b: MILPBuilder, prefix: str, points: List[int],
               values: List[float], n_var_coeffs: Dict[int, float]):
    """Append an SOS2 piecewise-linear block.

    Encodes  value = O(n)  where n = sum(n_var_coeffs) and O interpolates
    (points, values).  SOS2 (<=2 adjacent nonzero weights) is enforced with
    segment-selection binaries — the standard λ-formulation, equivalent to
    native solver SOS2 sets (which scipy's HiGHS interface lacks).

    Returns (w_indices, value_coeffs: dict var->coef contributing O(n)).
    """
    d = len(points)
    w = b.add_vars(f"w_{prefix}", d, lb=0.0, ub=1.0)
    seg = b.add_vars(f"seg_{prefix}", d - 1, binary=True)
    # sum w = 1
    b.add_row({i: 1.0 for i in w}, lb=1.0, ub=1.0)
    # sum seg = 1
    b.add_row({i: 1.0 for i in seg}, lb=1.0, ub=1.0)
    # w_i <= seg_{i-1} + seg_i  (adjacency)
    for i in range(d):
        row = {w[i]: 1.0}
        if i > 0:
            row[seg[i - 1]] = -1.0
        if i < d - 1:
            row[seg[i]] = -1.0
        b.add_row(row, ub=0.0)
    # sum w_i * points_i == n
    row = {w[i]: float(points[i]) for i in range(d)}
    for var, coef in n_var_coeffs.items():
        row[var] = row.get(var, 0.0) - coef
    b.add_row(row, lb=0.0, ub=0.0)
    value_coeffs = {w[i]: float(values[i]) for i in range(d)}
    return w, value_coeffs
