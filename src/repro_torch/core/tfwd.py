"""Adaptive forward-looking time estimation.

The paper (§3.4.3): "In practice, T_fwd is not predictable because of the
uncertainty of job submission to the main queue.  For a new system,
however, we can look into the scheduler logs to extract a representative
T_fwd statistically … an estimation (with reduced variance) based on the
current state of scheduler queue … may benefit the optimization."

This module implements that suggestion (beyond-paper, recorded in
EXPERIMENTS.md): an online quantile estimator over the observed gaps
between *shrink* events (nodes leaving N) — the events that actually
invalidate a forward-looking assumption.  Using a conservative quantile
(default q=0.35) of the recent gap distribution reproduces the paper's
observation that mild under-estimates of T_fwd are safer than
over-estimates (Fig 8 ROI), while adapting when the machine's churn
changes instead of requiring manual tuning.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Optional, Tuple, Union

import numpy as np


@dataclass
class TfwdEstimator:
    """Online T_fwd from observed leave-event gaps."""

    quantile: float = 0.35
    window: int = 64                # recent gaps kept
    t_min: float = 10.0             # clamp (paper sweeps 10..600 s)
    t_max: float = 600.0
    default: float = 120.0          # before any observation (paper's knee)

    _gaps: Deque[float] = field(default_factory=deque)
    _last_leave: Optional[float] = None

    def observe(self, time: float, nodes_left: int) -> None:
        """Feed every pool event; only shrink events advance the estimate."""
        if nodes_left <= 0:
            return
        if self._last_leave is not None:
            gap = time - self._last_leave
            if gap > 0:
                self._gaps.append(gap)
                while len(self._gaps) > self.window:
                    self._gaps.popleft()
        self._last_leave = time

    def estimate(self) -> float:
        if len(self._gaps) < 4:
            return self.default
        q = float(np.quantile(np.asarray(self._gaps), self.quantile))
        return float(np.clip(q, self.t_min, self.t_max))


def resolve_tfwd(t_fwd: Union[float, str]
                 ) -> Tuple[Optional[TfwdEstimator], float]:
    """Parse a ``t_fwd`` config value as the ControlLoop accepts it: a
    constant (the paper's fixed forward-looking time) returns
    ``(None, value)``; the string ``"adaptive"`` returns a fresh estimator
    and its pre-observation default."""
    if t_fwd == "adaptive":
        est = TfwdEstimator()
        return est, est.default
    return None, float(t_fwd)
