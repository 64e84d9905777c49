"""ElasticTrainer: elastic training on the card (counterpart of
``repro.elastic.trainer``).

A Trainer can be rescaled at runtime (paper §4.3).  ``rescale(0)`` parks
it: params and optimizer state are copied to the host (``Snapshot``) and
the card's copies are released.  ``rescale(1)`` puts them back on the
card.  Both walls are measured and kept in ``rescale_history``, so the
MILP can be driven by real ``R^up/R^dw`` values.  No durable-storage
round trip.

This slice trains on one card: a rescale to more nodes than there are
cards raises ``ValueError`` as in the JAX package, and a rescale to more
than one node with enough cards raises ``NotImplementedError`` (data
parallelism is the distribution slice, ROADMAP.md Queue 1).

The model holds its weights (``repro_torch.models.Model`` is built from a
``torch.Generator``); ``seed`` seeds the data pipeline, as it does in the
JAX trainer.  A train step is the JAX ``_train_step``: loss and
gradients, the schedule read at the optimizer step before its increment,
and one AdamW update at ``lr_scale * schedule``, in place.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, Snapshot
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import Model
from repro_torch.models.layers import resolve_device
from repro_torch.optim import AdamW, AdamWState, linear_scaling, \
    warmup_cosine


@dataclass
class TrainMetrics:
    step: int
    n_nodes: int
    loss: float
    samples: int
    step_time_s: float


class ElasticTrainer:
    """One Trainer: a model + optimizer + data pipeline that can run at any
    node count the card supports and be parked on the host cheaply."""

    def __init__(self, model: Model, *, optimizer: Optional[AdamW] = None,
                 per_node_batch: int = 8, devices_per_node: int = 1,
                 base_lr_nodes: int = 1, seed: int = 0,
                 warmup_steps: int = 20, total_steps: int = 10_000,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.optimizer = optimizer or AdamW()
        self.per_node_batch = per_node_batch
        self.devices_per_node = devices_per_node
        self.base_lr_nodes = base_lr_nodes
        self.warmup_steps = warmup_steps
        self.total_steps = total_steps
        self.pipeline = TokenPipeline(DataConfig(
            vocab_size=model.cfg.vocab_size, seq_len=256,
            per_node_batch=per_node_batch, seed=seed))

        # the model's own Parameters, keyed by state_dict name; rescales
        # move their storage, never replace them
        self.params: Dict[str, torch.nn.Parameter] = dict(
            model.named_parameters())
        self.opt_state = self.optimizer.init(self.params)
        self.step_count = 0
        self.n_nodes = 0
        self.last_rescale_s = 0.0
        self.rescale_history: list[tuple[int, int, float]] = []

    # ------------------------------------------------------------------

    def seq_len(self, seq_len: int) -> None:
        self.pipeline.cfg.seq_len = seq_len

    def _n_devices(self) -> int:
        return (torch.cuda.device_count() if self.device.type == "cuda"
                else 1)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _adopt(self, params: Dict[str, torch.Tensor],
               opt_state: AdamWState) -> None:
        """Point the Parameters at ``params``' tensors (same dtypes) and
        take ``opt_state`` as the optimizer state."""
        with torch.no_grad():
            for name, p in self.params.items():
                p.grad = None
                p.data = params[name].to(p.dtype)
        self.opt_state = opt_state

    def _place(self, device: torch.device) -> None:
        st = self.opt_state
        move = lambda t: t.to(device)  # noqa: E731
        self._adopt({n: move(p.data) for n, p in self.params.items()},
                    AdamWState(step=move(st.step),
                               mu={n: move(t) for n, t in st.mu.items()},
                               nu={n: move(t) for n, t in st.nu.items()}))

    def _train_step(self, batch: Dict[str, torch.Tensor],
                    lr_scale: torch.Tensor) -> torch.Tensor:
        for p in self.params.values():
            p.grad = None
        loss = self.model.loss(batch)
        loss.backward()
        grads = {n: p.grad for n, p in self.params.items()}
        sched = warmup_cosine(self.opt_state.step,
                              warmup_steps=self.warmup_steps,
                              total_steps=self.total_steps)
        _, self.opt_state = self.optimizer.update(
            grads, self.opt_state, self.params, lr_scale=lr_scale * sched)
        del grads
        for p in self.params.values():
            p.grad = None
        return loss.detach()

    # ------------------------------------------------------------------

    def rescale(self, n_nodes: int) -> float:
        """Rescale to ``n_nodes`` (0 = waiting).  Returns wall seconds."""
        t0 = time.perf_counter()
        old = self.n_nodes
        if n_nodes == old:
            return 0.0
        if n_nodes == 0:
            # hold state on host; release the card's copies
            self._sync()
            self._adopt(Snapshot.take(
                {n: p.data for n, p in self.params.items()},
                self.step_count).tree,
                Snapshot.take(self.opt_state, self.step_count).tree)
            self.n_nodes = 0
            dt = time.perf_counter() - t0
            self.rescale_history.append((old, 0, dt))
            return dt
        n_dev = n_nodes * self.devices_per_node
        if n_dev > self._n_devices():
            raise ValueError(
                f"rescale to {n_nodes} nodes needs {n_dev} devices, "
                f"only {self._n_devices()} available")
        if n_dev > 1:
            raise NotImplementedError(
                f"rescale to {n_nodes} nodes x {self.devices_per_node} "
                "devices: data-parallel training over more than one card "
                "is the distribution slice of the PyTorch port (ROADMAP.md, "
                "Queue 1)")
        self._place(self.device)
        self._sync()
        self.n_nodes = n_nodes
        dt = time.perf_counter() - t0
        self.last_rescale_s = dt
        self.rescale_history.append((old, n_nodes, dt))
        return dt

    def train_step(self) -> TrainMetrics:
        assert self.n_nodes > 0, "Trainer is waiting (0 nodes)"
        batch_np = self.pipeline.next_batch(self.n_nodes)
        batch = {k: torch.from_numpy(v).to(self.device, torch.int64)
                 for k, v in batch_np.items()}
        lr_scale = torch.tensor(linear_scaling(self.n_nodes,
                                               self.base_lr_nodes),
                                dtype=torch.float32, device=self.device)
        t0 = time.perf_counter()
        loss = float(self._train_step(batch, lr_scale))
        dt = time.perf_counter() - t0
        self.step_count += 1
        return TrainMetrics(step=self.step_count, n_nodes=self.n_nodes,
                            loss=loss,
                            samples=batch_np["tokens"].shape[0],
                            step_time_s=dt)

    # ------------------------------------------------------------------

    def _tree(self) -> dict:
        return {"params": {n: p.data for n, p in self.params.items()},
                "opt_state": self.opt_state}

    def save_checkpoint(self, manager: CheckpointManager,
                        meta: Optional[Dict] = None) -> str:
        """Write a durable, integrity-checked checkpoint of params +
        optimizer state at the current step, in the JAX package's format.
        Returns the npz path."""
        tree = Snapshot.take(self._tree()).tree
        return manager.save(tree, step=self.step_count, meta=meta)

    def restore_checkpoint(self, manager: CheckpointManager) -> int:
        """Restore from the newest checkpoint that passes verification.

        A corrupt latest checkpoint silently falls back to the previous
        good one (``CheckpointManager.load_latest_good``).  The state lands
        where the trainer's state lives now (the card when running, the
        host when parked).  Returns the restored step count; raises
        ``CorruptCheckpointError`` if no checkpoint survives."""
        home = next(iter(self.params.values())).device
        tree, meta, step = manager.load_latest_good(self._tree())
        st = tree["opt_state"]
        self._adopt(tree["params"], AdamWState(
            step=st.step.to(torch.int32), mu=st.mu, nu=st.nu))
        self._place(home)
        self.step_count = int(meta.get("step", step))
        return self.step_count

    # ------------------------------------------------------------------

    def measured_rescale_costs(self) -> tuple[float, float]:
        """(r_up, r_dw) estimates from observed rescales.

        A transition to 0 nodes is a *kill/park* (state copied to the host
        and the card's copies released), not a scale-down of a running
        mesh — its wall time is dominated by the host transfer and would
        contaminate the ``r_dw`` fed back into the MILP's Eqn-16 cost
        term, so it is excluded from the estimate.
        """
        ups = [dt for a, b, dt in self.rescale_history if b > a > 0]
        dws = [dt for a, b, dt in self.rescale_history if 0 < b < a]
        r_up = float(np.mean(ups)) if ups else 0.5
        r_dw = float(np.mean(dws)) if dws else 0.1
        return r_up, r_dw
