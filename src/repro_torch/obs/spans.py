"""Span/event records and trace export (DESIGN.md §13).

Every control-plane observation is a ``SpanEvent`` with **two clocks**:

* ``t0``/``t1`` — *trace clock*: simulated seconds on the replayed
  timeline (``ControlLoop``'s ``now``).  Deterministic: a same-seed
  replay emits identical values, which is what the trace-determinism
  test compares.
* ``wall_s`` — *wall clock*: physical seconds the observed operation
  took (solver wall, rescale wall), or ``None`` for instants and pure
  trace-clock spans.  Physical time varies run-to-run, so it is
  excluded from the deterministic JSONL by default.

Two serializations:

* ``to_jsonl`` / ``read_jsonl`` — one JSON object per line, schema
  ``bftrainer-trace/1`` (header line), stable key set
  ``TRACE_EVENT_KEYS``.  ``scripts/check_docs.py`` cross-validates the
  documented schema fence against these constants.
* ``chrome_trace`` — Chrome trace-event JSON (the ``traceEvents``
  format), loadable in Perfetto.  The timeline axis is the *trace
  clock* (µs); decision spans additionally render their *wall*
  duration on the dedicated allocator track, so both "where did the
  node-seconds go" and "where did the solver milliseconds go" are
  visible in one trace.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, IO, Iterable, List, Optional, Union

#: versioned schema tag for the JSONL trace stream; bump on any
#: incompatible change to the per-line layout
TRACE_SCHEMA = "bftrainer-trace/1"

#: the stable per-event key set (every JSONL line carries all of them;
#: unused ones are null) — documented in EXPERIMENTS.md §Telemetry and
#: cross-validated by scripts/check_docs.py
TRACE_EVENT_KEYS = ["kind", "cat", "name", "t0", "t1", "job", "value",
                    "wall_s", "args"]

#: event kinds: a complete trace-clock span, an instantaneous marker,
#: and a sampled counter value (rendered as a Perfetto counter track)
KIND_SPAN = "span"
KIND_INSTANT = "instant"
KIND_COUNTER = "counter"


@dataclass
class SpanEvent:
    """One observation.  ``kind`` is span/instant/counter; ``cat`` is the
    subsystem (``solver``, ``job``, ``loop``, ``chaos``, ``checkpoint``);
    ``job`` ties the event to a Trainer id where applicable."""

    kind: str
    cat: str
    name: str
    t0: float
    t1: float
    job: Optional[int] = None
    value: Optional[float] = None       # counter sample value
    wall_s: Optional[float] = None      # physical duration (second clock)
    args: Dict = field(default_factory=dict)

    def as_dict(self, include_wall: bool = True) -> Dict:
        d = {k: getattr(self, k) for k in TRACE_EVENT_KEYS}
        if not include_wall:
            d["wall_s"] = None
        return d


def to_jsonl(events: Iterable[SpanEvent], *,
             include_wall: bool = False) -> str:
    """Serialize events as JSONL: a schema header line followed by one
    event per line.  ``include_wall=False`` (default) nulls the
    wall-clock field so same-seed replays serialize bit-identically."""
    lines = [json.dumps({"schema": TRACE_SCHEMA})]
    for ev in events:
        lines.append(json.dumps(ev.as_dict(include_wall=include_wall),
                                sort_keys=True))
    return "\n".join(lines) + "\n"


def read_jsonl(text_or_file: Union[str, IO]) -> List[SpanEvent]:
    """Parse a :func:`to_jsonl` stream back into ``SpanEvent``s.  Raises
    ``ValueError`` on a missing/unknown schema header."""
    if hasattr(text_or_file, "read"):
        text = text_or_file.read()
    else:
        text = text_or_file
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        return []
    header = json.loads(lines[0])
    if header.get("schema") != TRACE_SCHEMA:
        raise ValueError(
            f"unknown trace schema {header.get('schema')!r} "
            f"(expected {TRACE_SCHEMA!r})")
    out = []
    for ln in lines[1:]:
        d = json.loads(ln)
        out.append(SpanEvent(**{k: d.get(k) for k in TRACE_EVENT_KEYS}))
    # default-restore args for old/edited lines carrying null
    for ev in out:
        if ev.args is None:
            ev.args = {}
    return out


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto)
# ---------------------------------------------------------------------------

#: process ids for the three tracks of the control-plane trace
PID_POOL = 1          # counter tracks: pool size, allocated nodes
PID_ALLOCATOR = 2     # decision spans (wall-clock durations) + restarts
PID_JOBS = 3          # per-job lifecycle: run segments, stalls, faults

_US = 1e6             # trace seconds → trace-event microseconds


def _meta(pid: int, tid: int, what: str, name: str) -> Dict:
    return {"ph": "M", "pid": pid, "tid": tid, "name": what,
            "args": {"name": name}}


def chrome_trace(events: Iterable[SpanEvent]) -> Dict:
    """Render events as a Chrome trace-event JSON object
    (``{"traceEvents": [...]}``), loadable in Perfetto.

    Track layout:

    * ``pool`` (pid 1) — counter tracks (``ph:"C"``) for sampled values
      such as pool size and allocated nodes;
    * ``allocator`` (pid 2) — one span per allocation decision; the span
      *duration shown is the solver's wall time* (µs) while its position
      is the trace-clock instant the decision happened at (args carry
      both clocks);
    * ``jobs`` (pid 3) — two threads per Trainer: run segments
      (``job <id>``) and rescale/restart stalls (``job <id> stalls``),
      plus instant markers for admissions, kills and rollbacks.
    """
    out: List[Dict] = [
        _meta(PID_POOL, 0, "process_name", "pool"),
        _meta(PID_ALLOCATOR, 0, "process_name", "allocator"),
        _meta(PID_ALLOCATOR, 0, "thread_name", "decisions (wall)"),
        _meta(PID_JOBS, 0, "process_name", "jobs"),
    ]
    seen_jobs = set()
    for ev in events:
        ts = ev.t0 * _US
        if ev.kind == KIND_COUNTER:
            out.append({"ph": "C", "pid": PID_POOL, "tid": 0,
                        "name": ev.name, "ts": ts,
                        "args": {ev.name: ev.value}})
            continue
        args = dict(ev.args)
        if ev.wall_s is not None:
            args["wall_ms"] = ev.wall_s * 1e3
        args["t_trace"] = ev.t0
        if ev.cat == "solver":
            dur = (ev.wall_s or 0.0) * _US
            out.append({"ph": "X", "pid": PID_ALLOCATOR, "tid": 0,
                        "name": ev.name, "cat": ev.cat, "ts": ts,
                        "dur": dur, "args": args})
            continue
        if ev.job is not None and ev.job not in seen_jobs:
            seen_jobs.add(ev.job)
            out.append(_meta(PID_JOBS, 2 * ev.job + 1, "thread_name",
                             f"job {ev.job}"))
            out.append(_meta(PID_JOBS, 2 * ev.job + 2, "thread_name",
                             f"job {ev.job} stalls"))
        if ev.job is not None:
            stall = ev.name in ("stall", "restart-stall")
            pid, tid = PID_JOBS, 2 * ev.job + (2 if stall else 1)
        else:
            pid, tid = PID_ALLOCATOR, 0
        if ev.kind == KIND_SPAN and ev.t1 > ev.t0:
            out.append({"ph": "X", "pid": pid, "tid": tid, "name": ev.name,
                        "cat": ev.cat, "ts": ts,
                        "dur": (ev.t1 - ev.t0) * _US, "args": args})
        else:
            out.append({"ph": "i", "pid": pid, "tid": tid, "name": ev.name,
                        "cat": ev.cat, "ts": ts, "s": "t", "args": args})
    return {"traceEvents": out, "displayTimeUnit": "ms"}
