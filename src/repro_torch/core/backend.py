"""Execution backends for the ControlLoop (DESIGN.md §9).

The ``ControlLoop`` decides *who gets which nodes when*; an
``ExecutionBackend`` is where Trainer progress actually happens between
decisions.  Two substrates implement the protocol:

* ``AnalyticBackend`` — trace-driven simulation: progress is the integral
  of the Trainer's scaling curve over the interval (minus rescale stalls),
  and completion times are predicted analytically so the loop can cut an
  interval at the exact finish instant.
* ``LiveBackend`` — the deployable path: every allocation decision is
  executed against real ``ElasticTrainer``s (``rescale()`` +
  ``train_step()``), with trace time mapped to a per-interval step budget
  via ``time_scale`` and measured rescale costs fed back into the MILP.

The loop owns all cost *accounting* (stalls, rescale/preemption costs,
records); backends only execute.  Keeping both behind one protocol is
what makes the live path policy-complete: FCFS admission, ``pj_max``,
coalescing and preemption-stall bookkeeping apply identically.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.core.loop import TrainerJob
from repro_torch.obs.telemetry import NULL_TELEMETRY


class ExecutionBackend:
    """Protocol (as an overridable base) between ControlLoop and the
    substrate that executes its decisions.  All hooks receive the
    ``TrainerJob`` whose policy state (``nodes``, ``busy_until``,
    ``done``/``work``) the loop maintains."""

    name = "base"
    #: observation sink (repro_torch.obs); ``ControlLoop.run`` hands its own
    #: hub to a backend still carrying the null default, so substrate
    #: spans (live rescale walls, chaos faults) share the loop's trace
    telemetry = NULL_TELEMETRY

    def bind(self, jobs: Sequence[TrainerJob]) -> None:
        """Called once at loop start with the full (sorted) job list."""

    def refresh(self, job: TrainerJob, now: float) -> None:
        """Update job parameters (e.g. measured r_up/r_dw) before a solve."""

    def apply_allocation(self, job: TrainerJob, old_n: int,
                         now: float) -> None:
        """Execute the allocator's decision; ``job.nodes`` is already the
        new assignment, ``old_n`` the previous node count."""

    def on_preempt(self, job: TrainerJob, taken: List[int],
                   now: float) -> None:
        """Nodes ``taken`` left the pool mid-run; ``job.nodes`` is already
        the surviving set."""

    def on_fail(self, job: TrainerJob, failed: List[int],
                now: float) -> Optional[float]:
        """Nodes ``failed`` were hard-killed mid-run (DESIGN.md §12).

        Returns the progress value to restore ``job.done`` to — the last
        durable checkpoint on the ``ckpt_every`` lattice by default — or
        ``None`` to keep progress (continuous checkpointing).  The loop
        owns the rollback bookkeeping (``lost_progress``, restart-penalty
        stall); substrates override this to consult real checkpoint
        state (LiveBackend) or to inject corrupt-restore faults
        (``repro_torch.chaos.ChaosBackend``)."""
        if not (math.isfinite(job.ckpt_every) and job.ckpt_every > 0):
            return None
        return job.last_checkpoint()

    def eta(self, job: TrainerJob, now: float,
            horizon: float) -> Optional[float]:
        """Predicted completion time (absolute trace-clock seconds)
        under the current allocation, or ``None`` if unknown (the loop
        then integrates to the horizon)."""
        return None

    def advance(self, job: TrainerJob, start: float, end: float) -> float:
        """Execute/integrate progress over ``[start, end)`` (trace-clock
        seconds); returns progress units processed (samples analytic,
        samples-per-real-step live).  Must respect ``job.busy_until``
        (rescale stall) and update ``job.done``."""
        return 0.0

    def on_finish(self, job: TrainerJob, now: float) -> None:
        """``job.done`` reached ``job.work``; release execution resources."""


class AnalyticBackend(ExecutionBackend):
    """Scaling-curve integration — the simulation substrate (paper §4)."""

    name = "analytic"

    def eta(self, job: TrainerJob, now: float,
            horizon: float) -> Optional[float]:
        thr = job.throughput()
        if thr <= 0:
            return None
        start = max(now, job.busy_until)
        return start + (job.work - job.done) / thr

    def advance(self, job: TrainerJob, start: float, end: float) -> float:
        thr = job.throughput()
        t0 = max(start, min(job.busy_until, end))
        delta = max(0.0, end - t0) * thr
        delta = min(delta, job.work - job.done)   # clamp at completion
        job.done += delta
        return delta


class ServingBackend(AnalyticBackend):
    """Analytic substrate plus request-level serving (DESIGN.md §15).

    Jobs carrying a ``replica`` (``repro_torch.serving.ServingJob`` — duck-
    typed so core/ never imports the serving package) advance through
    their :class:`~repro_torch.serving.replica.ReplicaSet` discrete-event
    simulation instead of the scaling-curve integral: ``advance``
    ingests arrivals, batches queued requests at the capacity the
    current allocation provides, and returns requests served; ``done``
    counts served requests.  Training jobs in the same loop fall through
    to :class:`AnalyticBackend` untouched, so a mixed pool — and, in
    particular, a pool with *zero* serving jobs — behaves bit-identically
    to the analytic path (the zero-serving parity test pins this down).

    Per decision, ``refresh`` re-estimates the job's offered request
    rate over its forward ``rate_window`` and publishes it via
    ``job.rate`` — the demand signal ``LatencySLO`` provisions for.
    Drain semantics live in the replica: a graceful shrink/preemption
    never discards the in-flight batch; a hard failure (``on_fail``)
    drops exactly that batch and nothing else.
    """

    name = "serving"

    @staticmethod
    def _replica(job: TrainerJob):
        return getattr(job, "replica", None)

    def bind(self, jobs: Sequence[TrainerJob]) -> None:
        for job in jobs:
            ensure = getattr(job, "ensure_replica", None)
            if callable(ensure):
                ensure()
            rep = self._replica(job)
            if rep is not None:
                rep.telemetry = self.telemetry

    def refresh(self, job: TrainerJob, now: float) -> None:
        rep = self._replica(job)
        if rep is None:
            return super().refresh(job, now)
        window = float(getattr(job, "rate_window", 120.0))
        job.rate = rep.offered_rate(now, now + window)

    def eta(self, job: TrainerJob, now: float,
            horizon: float) -> Optional[float]:
        if self._replica(job) is not None:
            return None                  # a service never finishes
        return super().eta(job, now, horizon)

    def advance(self, job: TrainerJob, start: float, end: float) -> float:
        rep = self._replica(job)
        if rep is None:
            return super().advance(job, start, end)
        served = rep.run(start, end, rate=job.throughput(),
                         n_nodes=len(job.nodes),
                         busy_until=job.busy_until)
        job.done += float(served)
        return float(served)

    def on_fail(self, job: TrainerJob, failed: List[int],
                now: float) -> Optional[float]:
        rep = self._replica(job)
        if rep is None:
            return super().on_fail(job, failed, now)
        rep.drop_inflight(now)
        return None                      # served requests never roll back


class LiveBackend(ExecutionBackend):
    """Real elastic training — the deployable substrate (paper §4.3).

    Wraps ``ManagedTrainer``-like objects (duck-typed: ``id``, ``curve``,
    ``n_min``/``n_max``, ``target_steps``, ``steps_done``, ``samples_done``
    and a ``trainer`` with ``rescale``/``train_step``/``n_nodes``/
    ``measured_rescale_costs``) so core/ carries no JAX import.

    Trace time maps to execution via ``time_scale``: an interval of ``dt``
    trace seconds grants ``min(max_steps_per_interval,
    int(dt · time_scale · steps_per_second))`` real train steps, after
    deducting any rescale-stall overlap (``job.busy_until``, trace
    seconds).  ``job.work``/``job.done`` are counted in *steps* here
    (``target_steps``); per-interval outcome is real samples processed.
    """

    name = "live"

    def __init__(self, managed: Sequence, *, time_scale: float = 1.0,
                 steps_per_second: float = 1.0,
                 max_steps_per_interval: int = 4,
                 metric: str = "throughput",
                 measure_rescale_costs: bool = True):
        self.managed = {m.id: m for m in managed}
        self.time_scale = time_scale
        self.steps_per_second = steps_per_second
        self.max_steps_per_interval = max_steps_per_interval
        self.metric = metric
        # off → specs keep their initial r_up/r_dw (deterministic problem
        # sequences, e.g. for backend-parity tests)
        self.measure_rescale_costs = measure_rescale_costs
        self.losses: Dict[int, List[float]] = {m.id: [] for m in managed}

    def jobs(self) -> List[TrainerJob]:
        """TrainerJobs mirroring the managed trainers, for the loop.

        Per-job policy fields (``weight``/``deadline``/``budget`` — see
        ``repro_torch.core.objectives``) are carried over when the managed
        object declares them (duck-typed, defaults otherwise)."""
        out = []
        for m in self.managed.values():
            r_up, r_dw = m.trainer.measured_rescale_costs()
            job = TrainerJob(
                id=m.id, curve=m.curve,
                work=(float(m.target_steps) if m.target_steps is not None
                      else math.inf),
                n_min=m.n_min, n_max=m.n_max, r_up=r_up, r_dw=r_dw,
                metric=self.metric,
                weight=float(getattr(m, "weight", 1.0)),
                deadline=getattr(m, "deadline", None),
                budget=getattr(m, "budget", None))
            job.done = float(m.steps_done)
            out.append(job)
        return out

    def refresh(self, job: TrainerJob, now: float) -> None:
        if self.measure_rescale_costs:
            job.r_up, job.r_dw = \
                self.managed[job.id].trainer.measured_rescale_costs()

    def _sync(self, job: TrainerJob, now: float = 0.0) -> None:
        tr = self.managed[job.id].trainer
        if tr.n_nodes != len(job.nodes):
            old = tr.n_nodes
            t0 = time.perf_counter()
            tr.rescale(len(job.nodes))
            tel = self.telemetry
            if tel:
                # measured physical rescale duration — the live-path
                # analogue of the analytic r_up/r_dw model costs
                wall = time.perf_counter() - t0
                tel.observe("backend.rescale_ms", wall * 1e3)
                tel.instant("backend", "rescale", now, job=job.id,
                            old=old, new=len(job.nodes), wall_s=wall)

    def apply_allocation(self, job: TrainerJob, old_n: int,
                         now: float) -> None:
        self._sync(job, now)

    def on_preempt(self, job: TrainerJob, taken: List[int],
                   now: float) -> None:
        # departed nodes are gone now — shrink (or park) immediately, even
        # if the re-allocation itself is coalesced
        self._sync(job, now)

    def on_fail(self, job: TrainerJob, failed: List[int],
                now: float) -> Optional[float]:
        """Hard kill on the live path: roll the managed trainer's step
        counter back to the last checkpoint-lattice step so execution
        and policy state agree.  If the managed object exposes a
        ``restore_to_step(step)`` hook (e.g. backed by a
        ``repro_torch.checkpoint.CheckpointManager``), it is invoked so model/
        optimizer state really rewinds; otherwise only the counters do
        (the toy trainers are stateless enough for replay purposes)."""
        restored = super().on_fail(job, failed, now)
        if restored is None:
            return None
        m = self.managed[job.id]
        step = int(restored)
        hook = getattr(m, "restore_to_step", None)
        if callable(hook):
            step = int(hook(step))
        m.steps_done = min(m.steps_done, step)
        return float(m.steps_done)

    def advance(self, job: TrainerJob, start: float, end: float) -> float:
        m = self.managed[job.id]
        if m.trainer.n_nodes <= 0:
            return 0.0
        t0 = max(start, min(job.busy_until, end))
        dt = max(0.0, end - t0)
        n_steps = min(self.max_steps_per_interval,
                      max(0, int(dt * self.time_scale
                                 * self.steps_per_second)))
        samples = 0
        for _ in range(n_steps):
            if job.done >= job.work:
                break
            met = m.trainer.train_step()
            m.steps_done += 1
            m.samples_done += met.samples
            samples += met.samples
            self.losses[m.id].append(met.loss)
            job.done = float(m.steps_done)
        return float(samples)

    def on_finish(self, job: TrainerJob, now: float) -> None:
        m = self.managed[job.id]
        if m.trainer.n_nodes > 0:
            job.nodes = []
            self._sync(job, now)      # park: snapshot to host, free devices
        job.nodes = []
