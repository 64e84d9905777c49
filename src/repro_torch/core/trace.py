"""Idle-node traces: Summit-calibrated synthetic generator + CSV loader.

Real Summit LSF logs are not redistributable, so the generator is
calibrated to the paper's published statistics (§2.1, Tab. 1, Fig. 1):

* ~9% of node×time idle and unfillable (paper: 8.6% over two weeks,
  ~11% ratio in Tab. 1);
* ~58% of fragments shorter than 10 minutes;
* those short fragments carry only ~10% of idle node×time.

``trace_stats`` recomputes these quantities; tests assert the calibration.
A loader for real ``node,start,end`` CSV logs is provided for deployments
with access to scheduler logs.
"""
from __future__ import annotations

import csv
import gzip
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.events import (
    Fragment,
    PoolEvent,
    fragments_to_events,
    validate_fragments,
)

# Mixture calibration (seconds).  Short fragments: median ~3 min; long:
# median ~1.4 h.  Busy periods tuned for ~9% idle fraction.
SHORT_W = 0.58
SHORT_MU, SHORT_SIGMA = math.log(180.0), 0.9
LONG_MU, LONG_SIGMA = math.log(5000.0), 0.8
BUSY_MU, BUSY_SIGMA = math.log(24000.0), 0.7


def generate_summit_like(n_nodes: int = 1024, duration: float = 7 * 86400.0,
                         seed: int = 0) -> List[Fragment]:
    """Per-node alternating busy/idle renewal process."""
    rng = np.random.default_rng(seed)
    fragments: List[Fragment] = []
    for node in range(n_nodes):
        # random initial phase: start mid-busy
        t = -float(rng.uniform(0, math.exp(BUSY_MU)))
        while t < duration:
            busy = float(rng.lognormal(BUSY_MU, BUSY_SIGMA))
            t += busy
            if t >= duration:
                break
            if rng.uniform() < SHORT_W:
                idle = float(rng.lognormal(SHORT_MU, SHORT_SIGMA))
            else:
                idle = float(rng.lognormal(LONG_MU, LONG_SIGMA))
            start = max(t, 0.0)
            end = min(t + idle, duration)
            if end > start:
                fragments.append(Fragment(node=node, start=start, end=end))
            t += idle
    fragments.sort(key=lambda f: (f.start, f.node))
    return fragments


def open_maybe_gz(path, mode: str = "rt"):
    """Open a text file, transparently gunzipping ``.gz`` paths."""
    p = str(path)
    return gzip.open(p, mode) if p.endswith(".gz") else open(p, mode)


def load_trace_csv(path: str, *, validate: bool = True) -> List[Fragment]:
    """Load fragments from a ``node,start,end`` CSV (real scheduler logs).

    Accepts plain or gzipped (``.gz``) files.  Each row is validated —
    integer non-negative node id, ``end > start`` — and malformed rows
    raise ``ValueError`` naming the offending line, rather than silently
    corrupting the pool replay downstream.  ``validate=True`` additionally
    rejects overlapping per-node fragments.
    """
    out = []
    with open_maybe_gz(path) as f:
        reader = csv.DictReader(f)
        missing = {"node", "start", "end"} - set(reader.fieldnames or ())
        if missing:
            raise ValueError(
                f"{path}: missing column(s) {sorted(missing)} "
                f"(header must contain node,start,end)")
        for lineno, row in enumerate(reader, start=2):
            try:
                node = int(row["node"])
                start = float(row["start"])
                end = float(row["end"])
            except (TypeError, ValueError) as exc:
                raise ValueError(
                    f"{path}:{lineno}: malformed row {row}: {exc}") from exc
            if node < 0:
                raise ValueError(
                    f"{path}:{lineno}: negative node id {node}")
            if not end > start:
                raise ValueError(
                    f"{path}:{lineno}: end ({end}) must be > start ({start})")
            out.append(Fragment(node=node, start=start, end=end))
    if validate:
        validate_fragments(out)
    out.sort(key=lambda fr: (fr.start, fr.node))
    return out


@dataclass
class TraceStats:
    n_fragments: int
    n_events: int
    events_per_hour: float
    joins_per_hour: float
    leaves_per_hour: float
    pct_fragments_short: float        # < 10 min, by count
    share_nodetime_short: float       # < 10 min, by node x time
    idle_fraction: float              # of n_nodes x duration
    eq_nodes: float                   # paper Tab. 1 "eq-Nodes"
    mean_pool_size: float


def trace_stats(fragments: Sequence[Fragment], n_nodes: int,
                duration: float) -> TraceStats:
    lengths = np.array([f.length for f in fragments])
    total = lengths.sum()
    short = lengths < 600.0
    events = fragments_to_events(fragments)
    inner = [e for e in events if 0.0 < e.time < duration]
    hours = duration / 3600.0
    return TraceStats(
        n_fragments=len(fragments),
        n_events=len(inner),
        events_per_hour=len(inner) / hours,
        joins_per_hour=sum(1 for e in inner if e.joined) / hours,
        leaves_per_hour=sum(1 for e in inner if e.left) / hours,
        pct_fragments_short=float(short.mean()) if len(lengths) else 0.0,
        share_nodetime_short=float(lengths[short].sum() / total) if total else 0.0,
        idle_fraction=float(total / (n_nodes * duration)),
        eq_nodes=float(total / duration),
        mean_pool_size=float(total / duration),
    )


def clip_fragments(fragments: Sequence[Fragment], t0: float,
                   t1: float) -> List[Fragment]:
    out = []
    for f in fragments:
        s, e = max(f.start, t0), min(f.end, t1)
        if e > s:
            out.append(Fragment(node=f.node, start=s, end=e))
    return out


# The JAX package re-exports its scheduler-derived traces here lazily
# (from its ``sched`` package).  The scheduler is not copied into the port
# yet (ROADMAP.md, Queue 1), so asking for one of those names says so.
_SCHED_NAMES = ("SCENARIOS", "build_scenario", "all_scenarios",
                "run_scenario", "simulate_schedule", "synthetic_workload")


def __getattr__(name):
    if name in _SCHED_NAMES:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}: the scheduler "
            "traces (the JAX package's sched) are not ported yet")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
