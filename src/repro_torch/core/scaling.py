"""Trainer scaling curves ``O_j(N_j)``.

The paper (Tab. 2) measures weak-scaling throughput (samples/s) of seven
ImageNet DNNs on Summit at 1..64 nodes; those rows are embedded verbatim
and drive the faithful reproduction experiments.  For the assigned
JAX model zoo we synthesize curves from an Amdahl-style communication
model (and ``benchmarks/bench_throughput.py`` measures real curves for
the smoke variants).
"""
from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

# Paper Tab. 2 — samples/second (x1000) vs nodes, minibatch 32/GPU, Summit.
TAB2_NODES = [1, 2, 4, 8, 16, 32, 64]
TAB2 = {
    "AlexNet":    [7.1, 13.1, 21.1, 40.5, 74.0, 130.8, 202.1],
    "ResNet18":   [5.2, 10.6, 20.4, 39.6, 78.0, 144.8, 262.7],
    "MnasNet":    [3.2, 6.0, 11.5, 23.1, 43.9, 83.5, 160.5],
    "MobileNets": [3.0, 5.9, 11.4, 22.0, 42.5, 82.3, 155.2],
    "ShuffleNet": [2.8, 5.3, 10.0, 20.4, 38.9, 74.1, 145.1],
    "VGG-16":     [1.2, 2.4, 4.7, 9.3, 18.3, 36.2, 70.2],
    "DenseNet":   [1.0, 2.0, 3.8, 7.6, 15.0, 28.8, 57.8],
}


@dataclass(frozen=True)
class ScalingCurve:
    """Piecewise-linear throughput curve through (nodes, samples/s) points."""

    nodes: Tuple[int, ...]
    throughput: Tuple[float, ...]   # samples/s at each node count
    name: str = ""

    def __post_init__(self):
        assert len(self.nodes) == len(self.throughput) >= 2
        assert all(a < b for a, b in zip(self.nodes, self.nodes[1:]))

    # -- evaluation ----------------------------------------------------

    def __call__(self, n: float) -> float:
        """Interpolated throughput at n nodes (0 when n == 0)."""
        if n <= 0:
            return 0.0
        xs, ys = self.nodes, self.throughput
        if n <= xs[0]:
            return ys[0] * n / xs[0]
        if n >= xs[-1]:
            return ys[-1]
        i = bisect.bisect_right(xs, n) - 1
        t = (n - xs[i]) / (xs[i + 1] - xs[i])
        return ys[i] + t * (ys[i + 1] - ys[i])

    def efficiency(self, n: float) -> float:
        """Scaling efficiency: throughput normalized by perfect scaling."""
        if n <= 0:
            return 0.0
        per1 = self.throughput[0] / self.nodes[0]
        return self(n) / (n * per1)

    # -- MILP discretization --------------------------------------------

    def breakpoints(self, n_min: int, n_max: int, metric: str = "throughput",
                    max_points: int = 8) -> Tuple[List[int], List[float]]:
        """Discretization points for the SOS2 approximation, always
        including 0 (the waiting state, gain 0), n_min and n_max."""
        pts = {0, n_min, n_max}
        for x in self.nodes:
            if n_min <= x <= n_max:
                pts.add(int(x))
        pts = sorted(pts)
        # thin out to max_points, keeping endpoints
        while len(pts) > max_points:
            # drop the interior point whose removal changes the curve least
            best_i, best_err = None, None
            for i in range(1, len(pts) - 1):
                y0, y1, y2 = (self(pts[i - 1]), self(pts[i]), self(pts[i + 1]))
                t = (pts[i] - pts[i - 1]) / (pts[i + 1] - pts[i - 1])
                err = abs(y1 - (y0 + t * (y2 - y0)))
                if best_err is None or err < best_err:
                    best_i, best_err = i, err
            pts.pop(best_i)
        vals = [self._metric_value(p, metric) for p in pts]
        return pts, vals

    def _metric_value(self, n: float, metric: str) -> float:
        if n <= 0:
            return 0.0
        if metric == "throughput":
            return self(n)
        if metric == "efficiency":
            # paper §5.2: "scaling efficiency, a normalized version of
            # throughput that is agnostic to DNN throughput" — throughput in
            # units of the DNN's own single-node rate, so AlexNet's raw-rate
            # advantage over DenseNet disappears (fair share, Tab 4).
            per1 = self.throughput[0] / self.nodes[0]
            return self(n) / per1
        raise ValueError(metric)


def tab2_curve(name: str) -> ScalingCurve:
    return ScalingCurve(tuple(TAB2_NODES),
                        tuple(v * 1000.0 for v in TAB2[name]), name=name)


def all_tab2_curves() -> Dict[str, ScalingCurve]:
    return {k: tab2_curve(k) for k in TAB2}


def amdahl_curve(name: str, thr1: float, comm_frac: float,
                 max_nodes: int = 128) -> ScalingCurve:
    """Synthetic weak-scaling curve: per-step time = compute + comm where the
    all-reduce term grows as (n-1)/n (ring) — Amdahl-style saturation."""
    nodes, thr = [], []
    n = 1
    while n <= max_nodes:
        ring = (n - 1) / n if n > 1 else 0.0
        step_time = (1 - comm_frac) + comm_frac * (0.3 + 0.7 * ring) * (
            1 + 0.15 * math.log2(n))
        thr.append(thr1 * n / step_time / 1.0)
        nodes.append(n)
        n *= 2
    return ScalingCurve(tuple(nodes), tuple(thr), name=name)


def model_zoo_curves() -> Dict[str, ScalingCurve]:
    """Synthetic curves for the 10 assigned architectures.

    comm_frac is estimated from bytes-per-step / flops-per-step of each
    family (MoE all-to-all and SSM scans raise it; see DESIGN.md).
    """
    spec = {
        # name: (relative single-node throughput, comm fraction)
        "yi-6b": (1.00, 0.22),
        "jamba-v0.1-52b": (0.18, 0.38),
        "seamless-m4t-medium": (3.0, 0.15),
        "deepseek-v2-lite-16b": (0.55, 0.33),
        "minitron-8b": (0.80, 0.24),
        "gemma2-27b": (0.26, 0.30),
        "internvl2-76b": (0.09, 0.42),
        "granite-moe-3b-a800m": (2.0, 0.28),
        "mamba2-2.7b": (1.6, 0.18),
        "gemma-2b": (2.4, 0.14),
    }
    return {k: amdahl_curve(k, thr1 * 1000.0, cf)
            for k, (thr1, cf) in spec.items()}
