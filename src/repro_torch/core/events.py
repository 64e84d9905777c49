"""Idle-node pool events and fragments (paper §2.1 terminology).

A *fragment* is a period during which one node is idle; an *event* is a
time at which the idle pool N changes (nodes join and/or leave; multiple
simultaneous changes are one event).

Beyond the paper's join/leave kinds, an event may carry *failed* nodes
(DESIGN.md §12): a hard kill removes the node like a leave but without
the drain grace — the holding Trainer rolls its progress back to its
last checkpoint and pays a restart penalty on top of the forced
scale-down.  ``failed`` tuples are produced by the fault-injection layer
(``repro_torch.chaos``); trace-derived streams never carry them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np


@dataclass(frozen=True)
class Fragment:
    node: int
    start: float
    end: float

    @property
    def length(self) -> float:
        return self.end - self.start


@dataclass(frozen=True)
class PoolEvent:
    time: float
    joined: Tuple[int, ...] = ()
    left: Tuple[int, ...] = ()
    # hard node failures (kill, not drain): removed from the pool like
    # ``left``, but the loop additionally applies restart-penalty /
    # checkpoint-rollback semantics (DESIGN.md §12)
    failed: Tuple[int, ...] = ()
    # owning pool shard on the federated path (DESIGN.md §14); ``None``
    # on single-pool streams.  Set by ``split_events_by_pool`` — every
    # node in a tagged event belongs to that pool.
    pool: Optional[int] = None
    # monotone per-stream sequence number stamped by the resource
    # monitor (DESIGN.md §16); ``None`` on trusted offline streams.
    # The hygiene layer uses it for dedup and same-instant conflict
    # resolution; everything downstream ignores it.
    seq: Optional[int] = None


class EventStreamError(ValueError):
    """A malformed control-plane event stream: a leave/fail of a node
    that is not in the believed pool, a join of a node already live, or
    a negative pool size.  Raised only in ``strict=True`` paths — the
    default folds stay permissive for backward compatibility."""


def fragments_to_events(fragments: Sequence[Fragment]) -> List[PoolEvent]:
    """Convert fragments into a merged, time-sorted event stream.

    Vectorized (one lexsort over all endpoints + grouped slicing) so
    month-scale traces with 10⁵⁺ fragments convert in numpy time.
    """
    if not fragments:
        return []
    nodes = np.fromiter((f.node for f in fragments), dtype=np.int64,
                        count=len(fragments))
    starts = np.fromiter((f.start for f in fragments), dtype=float,
                         count=len(fragments))
    ends = np.fromiter((f.end for f in fragments), dtype=float,
                       count=len(fragments))
    times = np.concatenate([starts, ends])
    kind = np.concatenate([np.zeros(len(nodes), dtype=np.int8),
                           np.ones(len(nodes), dtype=np.int8)])
    nids = np.concatenate([nodes, nodes])
    order = np.lexsort((nids, kind, times))
    times, kind, nids = times[order], kind[order], nids[order]
    bounds = np.flatnonzero(np.diff(times)) + 1
    out: List[PoolEvent] = []
    lo = 0
    for hi in list(bounds) + [len(times)]:
        k = kind[lo:hi]
        nd = nids[lo:hi]
        out.append(PoolEvent(time=float(times[lo]),
                             joined=tuple(int(x) for x in nd[k == 0]),
                             left=tuple(int(x) for x in nd[k == 1])))
        lo = hi
    return out


def merge_events(events: Sequence[PoolEvent]) -> List[PoolEvent]:
    """Sort events and merge those sharing a timestamp into one event per
    time point, preserving sequential-application semantics: events at the
    same instant are applied in their given order, and the *last* action
    on a node wins (a leave followed by a rejoin keeps the node; a join
    followed by a leave drops it; a fail after any action kills the
    node).  Within one event joins apply before leaves before fails, so
    an injected kill always beats the trace's own same-instant action."""
    out: List[PoolEvent] = []
    for e in sorted(events, key=lambda e: e.time):
        if out and out[-1].time == e.time:
            delta: Dict[int, str] = {}
            for ev in (out[-1], e):
                for n in ev.joined:
                    delta[n] = "join"
                for n in ev.left:
                    delta[n] = "leave"
                for n in ev.failed:
                    delta[n] = "fail"
            out[-1] = PoolEvent(
                time=e.time,
                joined=tuple(sorted(n for n, v in delta.items()
                                    if v == "join")),
                left=tuple(sorted(n for n, v in delta.items()
                                  if v == "leave")),
                failed=tuple(sorted(n for n, v in delta.items()
                                    if v == "fail")))
        else:
            out.append(e)
    return out


def split_events_by_pool(events: Sequence[PoolEvent],
                         pool_of: Callable[[int], int]
                         ) -> Dict[int, List[PoolEvent]]:
    """Split a fleet event stream into per-pool, pool-tagged substreams.

    This is the federated ingestion primitive (DESIGN.md §14): an event
    touching nodes of pools {1, 3} becomes one sub-event in pool 1's
    stream and one in pool 3's — the other K−2 pools never see it, so a
    pool's decision cadence depends only on its own churn, never on the
    fleet's merged timeline.  Each sub-event carries ``pool=k`` and only
    that pool's nodes; within each substream, relative event order (and
    therefore sequential-application semantics) is preserved.
    """
    out: Dict[int, List[PoolEvent]] = {}
    for e in events:
        buckets: Dict[int, Dict[str, List[int]]] = {}
        for attr in ("joined", "left", "failed"):
            for n in getattr(e, attr):
                b = buckets.setdefault(pool_of(n), {"joined": [], "left": [],
                                                    "failed": []})
                b[attr].append(n)
        for k in sorted(buckets):
            b = buckets[k]
            out.setdefault(k, []).append(PoolEvent(
                time=e.time, joined=tuple(b["joined"]),
                left=tuple(b["left"]), failed=tuple(b["failed"]), pool=k))
    return out


def apply_events(live: Set[int], events: Sequence[PoolEvent], *,
                 strict: bool = False) -> Set[int]:
    """Fold ``events`` over a live-node set: joins add, leaves and
    failures remove.  Returns a new set (``live`` is not mutated) — the
    federated layer uses this to carry each pool's membership across
    decision epochs even when the pool's loop short-circuits.

    With ``strict=True`` a join of an already-live node or a leave/fail
    of an unknown node raises :class:`EventStreamError` instead of
    folding silently — the resilience layer (DESIGN.md §16) runs its
    believed-membership state machine in this mode so corruption cannot
    hide inside set semantics.
    """
    out = set(live)
    for e in events:
        if strict:
            for n in e.joined:
                if n in out:
                    raise EventStreamError(
                        f"t={e.time}: join of already-live node {n}")
            for n in e.left:
                if n not in out:
                    raise EventStreamError(
                        f"t={e.time}: leave of unknown node {n}")
            for n in e.failed:
                if n not in out:
                    raise EventStreamError(
                        f"t={e.time}: failure of unknown node {n}")
        out.update(e.joined)
        out.difference_update(e.left)
        out.difference_update(e.failed)
    return out


def pool_sizes(events: Sequence[PoolEvent], *,
               strict: bool = False) -> List[Tuple[float, int]]:
    """(time, |N|) step function after each event.

    With ``strict=True`` a negative running size raises
    :class:`EventStreamError` — a stream that removes more nodes than
    ever joined is corrupt, and the permissive default would silently
    report impossible pool sizes.
    """
    size = 0
    out = []
    for e in events:
        size += len(e.joined) - len(e.left) - len(e.failed)
        if strict and size < 0:
            raise EventStreamError(
                f"t={e.time}: pool size went negative ({size})")
        out.append((e.time, size))
    return out


def validate_events(events: Sequence[PoolEvent],
                    initial: Iterable[int] = ()) -> List[str]:
    """Return a list of human-readable problems in an event stream
    (empty when clean).  Non-raising companion to the ``strict=`` modes:
    the hygiene layer calls this to *count and classify* defects while
    still making progress, whereas ``apply_events(..., strict=True)``
    hard-fails on the first one.

    Checks, folding in order: non-monotone timestamps, joins of live
    nodes, leaves/failures of unknown nodes, duplicate ``seq`` stamps,
    and a node appearing in more than one action of a single event.
    """
    problems: List[str] = []
    live = set(initial)
    seen_seq: Set[int] = set()
    last_t = float("-inf")
    for e in events:
        if e.time < last_t:
            problems.append(
                f"t={e.time}: timestamp regresses (prev {last_t})")
        last_t = max(last_t, e.time)
        if e.seq is not None:
            if e.seq in seen_seq:
                problems.append(f"t={e.time}: duplicate seq {e.seq}")
            seen_seq.add(e.seq)
        sets = (set(e.joined), set(e.left), set(e.failed))
        for i in range(3):
            for j in range(i + 1, 3):
                for n in sorted(sets[i] & sets[j]):
                    problems.append(
                        f"t={e.time}: node {n} in multiple actions "
                        f"of one event")
        for n in e.joined:
            if n in live:
                problems.append(
                    f"t={e.time}: join of already-live node {n}")
        for n in e.left:
            if n not in live:
                problems.append(f"t={e.time}: leave of unknown node {n}")
        for n in e.failed:
            if n not in live:
                problems.append(
                    f"t={e.time}: failure of unknown node {n}")
        live.update(e.joined)
        live.difference_update(e.left)
        live.difference_update(e.failed)
    return problems


def validate_fragments(fragments: Iterable[Fragment]) -> None:
    """Raise ``ValueError`` on malformed fragments.

    Checks the invariants every trace producer must uphold: ``end > start``,
    non-negative node ids, and no two fragments of the same node overlapping
    (overlaps would double-count a node in the idle pool).
    """
    last_end: Dict[int, float] = {}
    for f in sorted(fragments, key=lambda f: (f.node, f.start)):
        if f.node < 0:
            raise ValueError(f"fragment has negative node id: {f}")
        if not f.end > f.start:
            raise ValueError(f"fragment has end <= start: {f}")
        prev = last_end.get(f.node)
        if prev is not None and f.start < prev:
            raise ValueError(
                f"fragments overlap on node {f.node}: "
                f"[{f.start}, {f.end}) starts before {prev}")
        last_end[f.node] = f.end


def merge_fragments(fragments: Iterable[Fragment],
                    gap: float = 0.0) -> List[Fragment]:
    """Merge same-node fragments separated by at most ``gap`` seconds.

    Vectorized sweep: fragments are lexsorted by (node, start) and each
    node's timeline is shifted onto its own disjoint band of the real
    line, so one global running-max of the end times finds every merge
    boundary without a per-node Python loop.
    """
    frs = list(fragments)
    if not frs:
        return []
    nd = np.fromiter((f.node for f in frs), dtype=np.int64, count=len(frs))
    s = np.fromiter((f.start for f in frs), dtype=float, count=len(frs))
    e = np.fromiter((f.end for f in frs), dtype=float, count=len(frs))
    order = np.lexsort((s, nd))
    nd, s, e = nd[order], s[order], e[order]
    lo = min(float(s.min()), 0.0)
    band = (float(e.max()) - lo) + gap + 1.0     # > any same-node span + gap
    off = nd.astype(float) * band - lo
    s2, e2 = s + off, e + off
    run_end = np.maximum.accumulate(e2)
    new_run = np.ones(len(s2), dtype=bool)
    new_run[1:] = s2[1:] > run_end[:-1] + gap
    heads = np.flatnonzero(new_run)
    out_node = nd[heads]
    out_start = s[heads]
    out_end = np.maximum.reduceat(e2, heads) - off[heads]
    view = np.lexsort((out_node, out_start))
    return [Fragment(node=int(out_node[i]), start=float(out_start[i]),
                     end=float(out_end[i])) for i in view]
