"""The BFTrainer control loop (paper §3–§5), shared by simulation and
live execution.

``ControlLoop`` owns the *policy*: the merged timeline of pool events and
Trainer arrivals, FCFS admission up to ``pj_max``, the event-coalescing
window, preemption handling, rescale-stall (``busy_until``) bookkeeping,
adaptive ``t_fwd`` estimation, and the per-event records.  What it does
*not* own is execution: progress integration and physical rescales are
delegated to an ``ExecutionBackend`` (core/backend.py) — analytic
scaling-curve integration for trace-driven simulation, or real
``ElasticTrainer`` steps for live runs.  One policy, two substrates
(DESIGN.md §9).

Cost semantics (paper §2.1/§3.4), identical for both backends:
* scale-up of Trainer j stalls all its nodes for ``r_up`` seconds,
  scale-down for ``r_dw`` seconds (costs measured both in seconds and in
  foregone samples O_j(C_j)·R);
* nodes leaving mid-run force a scale-down at cost ``r_dw`` (preemption);
  the preempted node-time itself is counted as preemption cost;
* nodes *failing* mid-run (``PoolEvent.failed``, DESIGN.md §12) are a
  preemption plus a restart: progress rolls back to the last good
  checkpoint (``ckpt_every`` lattice; the backend's ``on_fail`` picks
  the restore point) and ``restart_penalty`` extra stall seconds apply;
* a forced scale-down (preemption or kill) supersedes any in-flight
  rescale stall — the aborted rescale's residual stall is not served;
* Trainers are admitted FCFS, at most ``pj_max`` concurrently (§5.3).
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.core.allocator import Allocator
from repro_torch.core.events import PoolEvent, merge_events
from repro_torch.core.milp import AllocationProblem, TrainerSpec
from repro_torch.core.scaling import ScalingCurve
from repro_torch.core.tfwd import TfwdEstimator, resolve_tfwd
from repro_torch.obs.telemetry import NULL_TELEMETRY, Telemetry


@dataclass
class TrainerJob:
    """One Trainer (a DNN training job) submitted to BFTrainer.

    ``work``/``done`` are in the backend's progress unit: samples for the
    analytic backend, train steps for the live backend.  Times
    (``arrival``, ``deadline``, ``r_up``/``r_dw``) are in trace-clock
    seconds; ``budget`` is in node-seconds.

    The optional policy fields (``weight``, ``deadline``, ``budget``,
    ``rate``/``slo``) are read by the matching objectives in
    ``repro_torch.core.objectives`` (WeightedPriority / DeadlineAware /
    CostCap / LatencySLO) and are inert under the default Throughput
    policy.
    """

    id: int
    curve: ScalingCurve
    work: float                     # total progress units to process
    n_min: int = 1
    n_max: int = 64
    r_up: float = 20.0              # seconds (paper §2.1 example)
    r_dw: float = 5.0
    arrival: float = 0.0
    metric: str = "throughput"      # objective metric for the MILP
    # --- per-job policy fields (repro_torch.core.objectives) ---
    weight: float = 1.0             # admin priority weight (dimensionless)
    deadline: Optional[float] = None  # absolute trace-clock soft deadline (s)
    budget: Optional[float] = None    # node-seconds the job may consume
    # offered request rate (requests/s), None for training jobs; kept
    # fresh by ServingBackend.refresh and read by LatencySLO
    rate: Optional[float] = None
    slo: Optional[float] = None       # request-latency SLO target (s)
    # --- fault model (DESIGN.md §12) ---
    # checkpoint interval in progress units: a hard node failure rolls
    # ``done`` back to the last multiple of ``ckpt_every``.  The default
    # (inf) models continuous checkpointing — a kill loses no progress —
    # which keeps fault-free replays bit-identical to the pre-chaos loop.
    ckpt_every: float = math.inf
    # extra stall seconds charged per hard node failure (restart/restore
    # wall time), on top of the forced scale-down r_dw
    restart_penalty: float = 0.0

    # --- runtime state ---
    done: float = 0.0
    nodes: List[int] = field(default_factory=list)
    busy_until: float = 0.0         # rescale stall deadline
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    rescale_cost_s: float = 0.0
    rescale_cost_samples: float = 0.0
    preempt_cost_s: float = 0.0
    n_rescales: int = 0
    n_preemptions: int = 0
    n_failures: int = 0             # hard node failures survived
    lost_progress: float = 0.0      # progress units rolled back by kills
    restart_cost_s: float = 0.0     # restart-penalty stall seconds paid
    node_seconds: float = 0.0       # node-seconds consumed so far
    _bp_cache: Optional[tuple] = field(default=None, repr=False)

    def spec(self, max_points: int = 8, now: float = 0.0) -> TrainerSpec:
        """Project this job into the allocator's ``TrainerSpec`` as seen
        at trace time ``now``: the deadline becomes relative
        (seconds-from-now), the budget becomes the unspent remainder
        (node-seconds), and progress the completed work fraction.

        The SOS2 breakpoints are a pure function of the (frozen) curve
        and the size bounds, so they are computed once and memoized —
        ``spec()`` is called once per active Trainer per re-allocation,
        which makes it hot on month-scale replays.
        """
        key = (max_points, self.metric, self.n_min, self.n_max)
        if self._bp_cache is None or self._bp_cache[0] != key:
            self._bp_cache = (key, self.curve.breakpoints(
                self.n_min, self.n_max, metric=self.metric,
                max_points=max_points))
        pts, vals = self._bp_cache[1]
        finite_work = self.work if math.isfinite(self.work) else None
        progress = (min(self.done / self.work, 1.0)
                    if finite_work and self.work > 0 else 0.0)
        return TrainerSpec(
            id=self.id, n_min=self.n_min, n_max=self.n_max,
            r_up=self.r_up, r_dw=self.r_dw,
            points=tuple(pts), values=tuple(vals),
            weight=self.weight,
            deadline=(max(self.deadline - now, 0.0)
                      if self.deadline is not None else None),
            budget=(max(self.budget - self.node_seconds, 0.0)
                    if self.budget is not None else None),
            work=finite_work, progress=progress,
            rate=(round(max(self.rate, 0.0), 6)
                  if self.rate is not None else None),
            slo=self.slo)

    @property
    def finished(self) -> bool:
        return self.done >= self.work

    def throughput(self) -> float:
        return self.curve(len(self.nodes))

    def last_checkpoint(self) -> float:
        """Progress at the most recent durable checkpoint: the largest
        multiple of ``ckpt_every`` not exceeding ``done`` (``done``
        itself under the default continuous-checkpoint discipline)."""
        if not (math.isfinite(self.ckpt_every) and self.ckpt_every > 0):
            return self.done
        return math.floor(self.done / self.ckpt_every) * self.ckpt_every


@dataclass
class EventRecord:
    time: float
    pool_size: int
    rescale_cost_samples: float
    outcome_until_next: float
    solver_wall: float
    allocated: int = 0              # Σ nodes held by Trainers after the event


@dataclass
class LoopStats:
    """The shared report core: everything the ControlLoop itself measures,
    regardless of backend.  ``SimReport``/``RuntimeReport`` build on it."""

    total_samples: float
    makespan: float
    events_processed: int
    allocator: str
    per_trainer_runtime: Dict[int, float]
    rescale_cost_samples: float
    rescale_cost_s: float
    preempt_cost_s: float
    solver_wall_total: float
    event_records: List[EventRecord] = field(default_factory=list)
    unfinished: int = 0
    # fault-model totals (DESIGN.md §12); all zero on fault-free replays
    n_failures: int = 0
    lost_progress: float = 0.0
    restart_cost_s: float = 0.0

    def as_dict(self) -> Dict:
        """Dataclasses-derived serialization (``event_records`` become
        nested dicts): a new stats field cannot silently drift out of
        reports (regression-tested keys == fields)."""
        return dataclasses.asdict(self)


class ControlLoop:
    """The single policy engine behind ``Simulator`` and
    ``BFTrainerRuntime``.

    Parameters
    ----------
    events : sequence of PoolEvent
        Idle-pool join/leave timeline (trace-clock seconds).
    jobs : sequence of TrainerJob
        Trainers, admitted FCFS by ``arrival``.
    allocator : Allocator
        Per-event allocation solver (engine, MILP, heuristic, ...).
    backend : ExecutionBackend
        Where progress happens between decisions (core/backend.py).
    t_fwd : float or "adaptive"
        Forward-looking window (seconds) or the online estimator.
    pj_max : int
        Max concurrently admitted Trainers (paper §5.3).
    horizon : float, optional
        Stop time (trace-clock seconds); default = last timeline point.
    sos2_points : int
        Max SOS2 breakpoints per Trainer curve.
    coalesce_window : float
        Defer re-allocation while further pool events land within this
        window (seconds); 0 disables (DESIGN.md §3.4).
    objective : Objective | str, optional
        Allocation policy passed to every solve (repro_torch.core.objectives);
        ``None`` = the paper's Eqn-16 throughput (DESIGN.md §10).
    telemetry : repro_torch.obs.Telemetry, optional
        Observation sink for decision spans, per-job lifecycle events
        and pool counter tracks (DESIGN.md §13).  Default is the no-op
        ``NULL_TELEMETRY``; the loop never *reads* telemetry, so an
        enabled hub cannot change any decision or stat.
    t_start : float, optional
        Resume the loop mid-trace: integration starts at ``t_start``
        (events before it are dropped, arrivals before it admit at it)
        instead of the first timeline point.  Used by the federated
        epoch replay (DESIGN.md §14) to run one decision epoch per call
        while job state carries across calls.  ``None`` (default) keeps
        the from-the-top semantics bit-identical.
    initial_pool : sequence of int, optional
        Idle-pool membership at ``t_start`` (nodes that joined before
        the window).  Only meaningful with ``t_start``; default empty.
    """

    def __init__(self, events: Sequence[PoolEvent],
                 jobs: Sequence[TrainerJob], allocator: Allocator,
                 backend, *, t_fwd: Union[float, str] = 120.0,
                 pj_max: int = 10, horizon: Optional[float] = None,
                 sos2_points: int = 8, coalesce_window: float = 0.0,
                 objective=None, telemetry: Optional[Telemetry] = None,
                 t_start: Optional[float] = None,
                 initial_pool: Sequence[int] = ()):
        self.events = sorted(events, key=lambda e: e.time)
        self.t_start = t_start
        self.initial_pool = tuple(initial_pool)
        self.jobs = sorted(jobs, key=lambda j: (j.arrival, j.id))
        self.allocator = allocator
        self.backend = backend
        # t_fwd: a constant (paper) or "adaptive" (beyond-paper online
        # quantile estimator over leave-event gaps, core/tfwd.py)
        self.t_fwd_estimator, self.t_fwd = resolve_tfwd(t_fwd)
        # allocation policy (repro_torch.core.objectives): an Objective, a
        # registry name, or None for the paper's Eqn-16 throughput
        self.objective = objective
        self.pj_max = pj_max
        self.horizon = horizon
        self.sos2_points = sos2_points
        # coalesce_window > 0: defer re-allocation while further pool events
        # land within the window, so a join/leave burst triggers one solve
        # instead of N (DESIGN.md §3.4).  Preemption of departed nodes is
        # never deferred — only the hand-out of new assignments is.
        self.coalesce_window = coalesce_window
        self.telemetry = telemetry or NULL_TELEMETRY

    # ------------------------------------------------------------------

    def run(self) -> LoopStats:
        backend = self.backend
        jobs = self.jobs
        tel = self.telemetry
        # hand the hub to an unwired backend so substrate-level spans
        # (live rescale walls, chaos faults) land in the same trace
        if tel and getattr(backend, "telemetry", None) in (None,
                                                           NULL_TELEMETRY):
            backend.telemetry = tel
        backend.bind(jobs)
        pool: set[int] = set(self.initial_pool)
        qi = 0                                        # FCFS admission pointer
        active: List[TrainerJob] = []
        finished: List[TrainerJob] = []
        records: List[EventRecord] = []
        solver_wall = 0.0
        total_outcome = 0.0

        # one event per time point (hand-built streams may carry several
        # events at one timestamp; sequential last-action-wins semantics)
        events = merge_events(self.events)
        t0 = self.t_start
        if t0 is not None:
            events = [e for e in events if e.time >= t0]
        # merged timeline: pool events + job arrivals (+ completions found
        # during integration).  On a windowed run, arrivals before the
        # window admit at its opening instant (FCFS order is preserved:
        # jobs stay sorted by their true arrival).
        times = sorted({e.time for e in events}
                       | {j.arrival if t0 is None else max(j.arrival, t0)
                          for j in jobs})
        ev_by_time: Dict[float, PoolEvent] = {e.time: e for e in events}
        if not times:
            return LoopStats(0.0, 0.0, 0, self.allocator.name, {}, 0.0, 0.0,
                             0.0, 0.0)
        t_end = self.horizon if self.horizon is not None else times[-1]

        ev_times = [e.time for e in events]
        i = 0
        now = times[0]
        n_events = 0
        pending_realloc = True
        pending_since: Optional[float] = None
        while now < t_end and (i < len(times) or active or qi < len(jobs)):
            # 1) apply pool event at `now`, if any: join/leave + preemption
            ev = ev_by_time.get(now)
            if ev is not None:
                if self.t_fwd_estimator is not None:
                    self.t_fwd_estimator.observe(now,
                                                 len(ev.left) + len(ev.failed))
                for nid in ev.joined:
                    pool.add(nid)
                failed = set(ev.failed)
                lost = set(ev.left) | failed
                pool -= lost
                if tel:
                    tel.instant("loop", "pool-event", now,
                                joined=len(ev.joined), left=len(ev.left),
                                failed=len(ev.failed))
                for j in active:
                    taken = [n for n in j.nodes if n in lost]
                    if taken:
                        j.nodes = [n for n in j.nodes if n not in lost]
                        j.n_preemptions += 1
                        j.preempt_cost_s += len(taken) * j.r_dw
                        if tel:
                            tel.instant("job", "preempt", now, job=j.id,
                                        taken=len(taken))
                        penalty = 0.0
                        dead = [n for n in taken if n in failed]
                        if dead:
                            # hard kill: roll progress back to the last
                            # good checkpoint (the backend picks it — a
                            # corrupt latest checkpoint restores one
                            # interval further back) and charge the
                            # restart penalty (DESIGN.md §12)
                            j.n_failures += 1
                            restored = backend.on_fail(j, dead, now)
                            lost_now = 0.0
                            if restored is not None and restored < j.done:
                                lost_now = j.done - restored
                                j.lost_progress += lost_now
                                j.done = restored
                            penalty = j.restart_penalty
                            j.restart_cost_s += penalty
                            if tel:
                                tel.instant("job", "fail", now, job=j.id,
                                            lost=lost_now, penalty_s=penalty)
                        if j.nodes:
                            # forced scale-down stall.  It *supersedes*
                            # any in-flight rescale stall instead of
                            # stacking on top of it: the interrupted
                            # rescale is aborted, and serving its
                            # residual stall after the kill would charge
                            # R_up twice (the kill-during-rescale
                            # double-count, tests/test_loop.py)
                            j.busy_until = now + j.r_dw + penalty
                            j.rescale_cost_s += j.r_dw
                            if tel:
                                tel.span("job", "stall", now, j.busy_until,
                                         job=j.id, why="preempt",
                                         cost_s=j.r_dw + penalty)
                        elif penalty > 0.0:
                            # fully killed: the restart penalty is served
                            # when (before) it next gets nodes
                            j.busy_until = now + penalty
                            if tel:
                                tel.span("job", "stall", now, j.busy_until,
                                         job=j.id, why="restart",
                                         cost_s=penalty)
                        backend.on_preempt(j, taken, now)
                pending_realloc = True

            # 2) admit arrivals FCFS up to pj_max; a job that is already
            #    finished (e.g. a resumed live run) never takes a slot
            while qi < len(jobs) and jobs[qi].arrival <= now and \
                    len(active) < self.pj_max:
                job = jobs[qi]
                qi += 1
                if job.finished:
                    finished.append(job)
                    continue
                active.append(job)
                if tel:
                    tel.instant("job", "admit", now, job=job.id,
                                arrival=job.arrival,
                                wait=now - job.arrival)
                pending_realloc = True

            # 3) reallocate — unless a coalescing window says another pool
            #    event is imminent, in which case defer (bounded by one
            #    window from the first deferred event)
            realloc_cost_samples = 0.0
            ev_solver_wall = 0.0
            defer = False
            if pending_realloc and pending_since is None:
                pending_since = now
            if pending_realloc and self.coalesce_window > 0.0:
                k = bisect.bisect_right(ev_times, now)
                nxt_ev = ev_times[k] if k < len(ev_times) else None
                # never defer while a preemption left a Trainer below its
                # minimum size — running there violates Eqn 4 feasibility
                feasible = all(len(j.nodes) == 0 or len(j.nodes) >= j.n_min
                               for j in active)
                if feasible and nxt_ev is not None and nxt_ev < t_end and \
                        nxt_ev - now <= self.coalesce_window and \
                        now - pending_since < self.coalesce_window:
                    defer = True
            if pending_realloc and active and not defer:
                t_fwd = (self.t_fwd_estimator.estimate()
                         if self.t_fwd_estimator is not None else self.t_fwd)
                for j in active:
                    backend.refresh(j, now)
                prob = AllocationProblem(
                    nodes=sorted(pool),
                    trainers=[j.spec(self.sos2_points, now=now)
                              for j in active],
                    current={j.id: list(j.nodes) for j in active},
                    t_fwd=t_fwd,
                    objective=self.objective,
                    now=now,
                )
                res = self.allocator.allocate(prob)
                solver_wall += res.wall_time
                ev_solver_wall = res.wall_time
                for j in active:
                    new_nodes = res.allocation.get(j.id, [])
                    old = len(j.nodes)
                    new = len(new_nodes)
                    j.nodes = list(new_nodes)
                    if new != old:
                        cost = j.r_up if new > old else j.r_dw
                        j.busy_until = max(j.busy_until, now) + cost
                        j.rescale_cost_s += cost
                        c_samples = j.curve(old) * cost
                        j.rescale_cost_samples += c_samples
                        realloc_cost_samples += c_samples
                        j.n_rescales += 1
                        if tel:
                            tel.instant("job", "rescale", now, job=j.id,
                                        old=old, new=new, cost_s=cost)
                            tel.span("job", "stall", now, j.busy_until,
                                     job=j.id,
                                     why="grow" if new > old else "shrink",
                                     cost_s=cost)
                    if j.nodes and j.started_at is None:
                        j.started_at = now
                    backend.apply_allocation(j, old, now)
                n_events += 1
                if tel:
                    # one decision span per solve: position = trace-clock
                    # instant, cost = solver wall (the dual clock)
                    tel.observe("loop.decision_ms", res.wall_time * 1e3)
                    tel.span("solver", res.solver_status, now, now,
                             wall_s=res.wall_time, pool=len(pool),
                             jobs=len(active),
                             allocated=sum(len(j.nodes) for j in active))
            if not defer:
                pending_realloc = False
                pending_since = None

            # 4) integrate progress to the next timeline point (or a job
            #    completion, whichever comes first)
            nxt = t_end
            k = bisect.bisect_right(times, now, i)
            if k < len(times):
                nxt = min(nxt, times[k])
            for j in active:
                if j.nodes and not j.finished:
                    eta = backend.eta(j, now, nxt)
                    if eta is not None and now < eta < nxt:
                        nxt = eta
            outcome = 0.0
            for j in active:
                if j.nodes and not j.finished:
                    outcome += backend.advance(j, now, nxt)
                if j.nodes:
                    # node-seconds consumed (budget accounting, CostCap)
                    j.node_seconds += len(j.nodes) * (nxt - now)
            total_outcome += outcome
            records.append(EventRecord(
                time=now, pool_size=len(pool),
                rescale_cost_samples=realloc_cost_samples,
                outcome_until_next=outcome, solver_wall=ev_solver_wall,
                allocated=sum(len(j.nodes) for j in active)))
            if tel:
                rec = records[-1]
                tel.sample("pool_size", now, rec.pool_size)
                tel.sample("allocated", now, rec.allocated)
                if nxt > now:
                    for j in active:
                        if j.nodes:
                            tel.span("job", "run", now, nxt, job=j.id,
                                     n=len(j.nodes))

            # 5) retire finished jobs
            newly_done = [j for j in active if j.finished]
            if newly_done:
                for j in newly_done:
                    j.finished_at = nxt
                    backend.on_finish(j, nxt)
                    if tel:
                        tel.instant("job", "finish", nxt, job=j.id)
                    finished.append(j)
                active = [j for j in active if not j.finished]
                pending_realloc = True

            # advance
            while i < len(times) and times[i] <= nxt:
                i += 1
            now = nxt
            if not active and qi >= len(jobs):
                break            # no job left; replaying more events is idle
            if not ev_by_time.get(now) and not newly_done and \
                    not (qi < len(jobs) and jobs[qi].arrival <= now) and \
                    i >= len(times):
                break

        all_jobs = finished + active + jobs[qi:]
        # pre-finished jobs still queued (never admitted) are not unfinished
        queued = [j for j in jobs[qi:] if not j.finished]
        per_rt = {j.id: (j.finished_at - j.arrival)
                  for j in finished if j.finished_at is not None}
        stats = LoopStats(
            total_samples=total_outcome,
            makespan=now - times[0],
            events_processed=n_events,
            allocator=self.allocator.name,
            per_trainer_runtime=per_rt,
            rescale_cost_samples=sum(j.rescale_cost_samples for j in all_jobs),
            rescale_cost_s=sum(j.rescale_cost_s for j in all_jobs),
            preempt_cost_s=sum(j.preempt_cost_s for j in all_jobs),
            solver_wall_total=solver_wall,
            event_records=records,
            unfinished=len(active) + len(queued),
            n_failures=sum(j.n_failures for j in all_jobs),
            lost_progress=sum(j.lost_progress for j in all_jobs),
            restart_cost_s=sum(j.restart_cost_s for j in all_jobs),
        )
        if tel:
            # mirror the scalar report fields as hub gauges, so the hub
            # alone reconstructs the run summary (LoopStats stays the
            # canonical report object — this is the thin-view mirror)
            for f in dataclasses.fields(LoopStats):
                v = getattr(stats, f.name)
                if isinstance(v, (int, float)):
                    tel.gauge(f"loop.{f.name}", v)
        return stats
