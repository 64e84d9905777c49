"""The telemetry hub: counters, gauges, streaming histograms, spans
(DESIGN.md §13).

``Telemetry`` is a passive sink — instrumented code calls ``count`` /
``gauge`` / ``observe`` / ``span`` / ``instant`` / ``sample`` and the
hub accumulates.  It never feeds back into decisions, so enabling it
cannot change any allocation (the enabled-vs-disabled parity test in
tests/test_obs.py).

``NullTelemetry`` is the default everywhere: every method is a no-op
and the instance is *falsy*, so hot paths guard with ``if tel:`` and
skip even argument construction — the zero-overhead-when-disabled
argument (DESIGN.md §13).

``Histogram`` is a streaming log-bucketed histogram: exact samples are
kept up to ``exact_cap`` (percentiles are exact at benchmark scales),
after which only ~7%-resolution geometric buckets accumulate (bounded
memory on month-scale replays).  Everything is deterministic — no
randomness, no wall-clock reads — so same-seed replays produce
bit-identical histogram state.
"""
from __future__ import annotations

import bisect
import json
import math
from typing import Dict, List, Optional

from repro_torch.obs.spans import (
    KIND_COUNTER,
    KIND_INSTANT,
    KIND_SPAN,
    SpanEvent,
    chrome_trace,
    to_jsonl,
)

#: geometric bucket growth: ~7% relative resolution on percentiles once
#: a histogram overflows its exact-sample cap
_GROWTH = 1.07
_LOG_GROWTH = math.log(_GROWTH)


class Histogram:
    """Streaming histogram with p50/p95/p99 (and any other quantile).

    Exact up to ``exact_cap`` samples; log-bucketed (~7% relative error)
    beyond.  Non-positive values land in a dedicated underflow bucket
    reported at 0.0.
    """

    __slots__ = ("exact_cap", "count", "total", "min", "max",
                 "_exact", "_buckets", "_zero")

    def __init__(self, exact_cap: int = 4096):
        self.exact_cap = exact_cap
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._exact: Optional[List[float]] = []
        self._buckets: Dict[int, int] = {}
        self._zero = 0                      # values <= 0

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        if self._exact is not None:
            bisect.insort(self._exact, value)
            if len(self._exact) > self.exact_cap:
                for v in self._exact:       # degrade to buckets once
                    self._bucket(v)
                self._exact = None
            return
        self._bucket(value)

    def _bucket(self, value: float) -> None:
        if value <= 0.0:
            self._zero += 1
            return
        idx = int(math.floor(math.log(value) / _LOG_GROWTH))
        self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def percentile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 100]; 0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        if self._exact is not None:
            # nearest-rank on the sorted exact samples
            k = max(0, min(len(self._exact) - 1,
                           int(math.ceil(q / 100.0 * len(self._exact))) - 1))
            return self._exact[k]
        rank = max(1, int(math.ceil(q / 100.0 * self.count)))
        if rank <= self._zero:
            return 0.0
        seen = self._zero
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if seen >= rank:
                # geometric midpoint of the bucket [G^idx, G^(idx+1))
                return math.exp((idx + 0.5) * _LOG_GROWTH)
        return self.max

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def merge(self, other: "Histogram") -> None:
        """Fold ``other``'s samples into this histogram (federated
        per-pool → fleet composition, DESIGN.md §14).  Exact+exact stays
        exact until the cap; any bucketed operand degrades the result to
        buckets (the percentile error stays the ~7% bucket resolution)."""
        if other.count == 0:
            return
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        if self._exact is not None and other._exact is not None \
                and len(self._exact) + len(other._exact) <= self.exact_cap:
            for v in other._exact:
                bisect.insort(self._exact, v)
            return
        if self._exact is not None:
            for v in self._exact:
                self._bucket(v)
            self._exact = None
        if other._exact is not None:
            for v in other._exact:
                self._bucket(v)
        else:
            self._zero += other._zero
            for idx, n in other._buckets.items():
                self._buckets[idx] = self._buckets.get(idx, 0) + n

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class Telemetry:
    """The hub.  All mutation goes through the six verbs below; exports
    (`summary` / `write_jsonl` / `write_chrome_trace`) are read-only."""

    enabled = True

    def __init__(self, *, exact_cap: int = 4096):
        self.exact_cap = exact_cap
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.events: List[SpanEvent] = []

    def __bool__(self) -> bool:
        return True

    # -- the six verbs -------------------------------------------------

    def count(self, name: str, delta: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + delta

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        """Add ``value`` to the streaming histogram ``name``."""
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(self.exact_cap)
        h.observe(value)

    def span(self, cat: str, name: str, t0: float, t1: float, *,
             job: Optional[int] = None, wall_s: Optional[float] = None,
             **args) -> None:
        """A completed span: ``[t0, t1]`` on the trace clock, optionally
        carrying the operation's physical duration ``wall_s``."""
        self.events.append(SpanEvent(KIND_SPAN, cat, name, float(t0),
                                     float(t1), job=job, wall_s=wall_s,
                                     args=args))

    def instant(self, cat: str, name: str, t: float, *,
                job: Optional[int] = None,
                wall_s: Optional[float] = None, **args) -> None:
        self.events.append(SpanEvent(KIND_INSTANT, cat, name, float(t),
                                     float(t), job=job, wall_s=wall_s,
                                     args=args))

    def sample(self, name: str, t: float, value: float) -> None:
        """Sample a counter track (e.g. pool size over trace time)."""
        self.events.append(SpanEvent(KIND_COUNTER, "counter", name,
                                     float(t), float(t),
                                     value=float(value)))

    def merge_from(self, other: "Telemetry", *, prefix: str = "") -> None:
        """Fold another hub into this one, optionally namespacing every
        metric with ``prefix`` (e.g. ``"pool3."``).  Counters and gauges
        add/overwrite, histograms merge sample-exactly where possible,
        and span events append in order — the federated layer calls this
        once per pool, in pool order, so fleet traces stay deterministic
        (DESIGN.md §14)."""
        for name, v in other.counters.items():
            key = prefix + name
            self.counters[key] = self.counters.get(key, 0.0) + v
        for name, v in other.gauges.items():
            self.gauges[prefix + name] = v
        for name, h in other.histograms.items():
            mine = self.histograms.get(prefix + name)
            if mine is None:
                mine = self.histograms[prefix + name] = \
                    Histogram(self.exact_cap)
            mine.merge(h)
        self.events.extend(other.events)

    # -- exports -------------------------------------------------------

    def hist_summary(self) -> Dict[str, Dict[str, float]]:
        return {name: h.summary()
                for name, h in sorted(self.histograms.items())}

    def summary(self) -> Dict:
        return {
            "counters": dict(sorted(self.counters.items())),
            "gauges": dict(sorted(self.gauges.items())),
            "histograms": self.hist_summary(),
            "n_events": len(self.events),
        }

    def to_jsonl(self, *, include_wall: bool = False) -> str:
        return to_jsonl(self.events, include_wall=include_wall)

    def write_jsonl(self, path: str, *, include_wall: bool = False) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_jsonl(include_wall=include_wall))

    def chrome_trace(self) -> Dict:
        return chrome_trace(self.events)

    def write_chrome_trace(self, path: str) -> None:
        """Write a Chrome trace-event JSON loadable in Perfetto
        (https://ui.perfetto.dev → *Open trace file*)."""
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.chrome_trace(), f)


class NullTelemetry(Telemetry):
    """The default sink: falsy, and every verb is a no-op — instrumented
    code is bit-identical to uninstrumented code (and hot paths guarded
    with ``if tel:`` skip argument construction entirely)."""

    enabled = False

    def __bool__(self) -> bool:
        return False

    def count(self, name, delta=1.0):
        pass

    def gauge(self, name, value):
        pass

    def observe(self, name, value):
        pass

    def span(self, cat, name, t0, t1, **kw):
        pass

    def instant(self, cat, name, t, **kw):
        pass

    def sample(self, name, t, value):
        pass

    def merge_from(self, other, *, prefix=""):
        pass


#: the shared default sink.  Stateless (all verbs drop), so one module
#: singleton can back every uninstrumented engine/loop at once.
NULL_TELEMETRY = NullTelemetry()
