"""The port's ElasticTrainer, checkpoints and BFTrainerRuntime on the CPU,
against the JAX package where it has a counterpart.

The first five tests are ``tests/test_elastic_serving.py``'s trainer
tests on the port.  The trainer comparison resumes both packages from
one checkpoint the JAX trainer wrote (params and AdamW state after one
step) and runs three more steps each in fp32: losses and every
parameter agree to 1e-4 of the leaf's largest magnitude (summation
order only).  The runtime comparison replays one trace through both
runtimes with measured rescale costs off, so both solve the same
problems: the events, steps and rescales must be equal.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_arch as jax_get_arch
from repro.core import MILPAllocator as JaxMILPAllocator
from repro.core import amdahl_curve as jax_amdahl_curve
from repro.core import fragments_to_events as jax_fragments_to_events
from repro.core import generate_summit_like as jax_generate_summit_like
from repro.elastic import BFTrainerRuntime as JaxRuntime
from repro.elastic import ElasticTrainer as JaxElasticTrainer
from repro.elastic import ManagedTrainer as JaxManagedTrainer
from repro.models import build_model
from repro.optim import AdamW as JaxAdamW
from repro_torch.bridge import torch_name
from repro_torch.checkpoint import (
    CheckpointManager,
    CorruptCheckpointError,
    Snapshot,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import get_arch
from repro_torch.core import (
    MILPAllocator,
    amdahl_curve,
    fragments_to_events,
    generate_summit_like,
)
from repro_torch.elastic import BFTrainerRuntime, ElasticTrainer, \
    ManagedTrainer
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import Model
from repro_torch.optim import AdamW


def small_trainer(arch="gemma-2b", seed=0, seq=48, lr=3e-3):
    cfg = get_arch(arch).reduced()
    gen = torch.Generator().manual_seed(seed)
    model = Model(cfg, device="cpu", generator=gen, remat=False)
    tr = ElasticTrainer(model, per_node_batch=2, seed=seed,
                        optimizer=AdamW(lr=lr), warmup_steps=2, device="cpu")
    tr.pipeline.cfg.seq_len = seq
    return tr


def jax_small_trainer(arch="gemma-2b", seed=0, seq=48, lr=3e-3):
    model = build_model(jax_get_arch(arch).reduced(), remat=False)
    tr = JaxElasticTrainer(model, per_node_batch=2, seed=seed,
                           optimizer=JaxAdamW(lr=lr), warmup_steps=2)
    tr.pipeline.cfg.seq_len = seq
    return tr


def _close(got, want, tol=1e-4):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= tol * scale


# ---------------------------------------------------------------------------
# ElasticTrainer (tests/test_elastic_serving.py's first five, on the port)
# ---------------------------------------------------------------------------


def test_elastic_trainer_trains_and_rescales():
    tr = small_trainer()
    tr.rescale(1)
    losses = [tr.train_step().loss for _ in range(6)]
    # rescale preserves state: params identical before/after
    before = [p.detach().clone() for p in tr.params.values()]
    tr.rescale(0)          # waiting (host snapshot)
    assert tr.n_nodes == 0
    tr.rescale(1)
    for b, a in zip(before, tr.params.values()):
        assert torch.equal(b, a.detach())
    # continues training from where it left off (step count preserved)
    m = tr.train_step()
    assert m.step == 7
    assert np.isfinite(m.loss)
    # loss should broadly decrease over continued training
    more = [tr.train_step().loss for _ in range(25)]
    assert np.mean(more[-5:]) < np.mean(losses[:3])


def test_elastic_trainer_measures_rescale_costs():
    tr = small_trainer(seed=1)
    tr.rescale(1)
    tr.train_step()
    tr.rescale(0)
    tr.rescale(1)
    r_up, r_dw = tr.measured_rescale_costs()
    assert r_up > 0 and r_dw >= 0
    # 0->1, 1->0, 0->1 (no-op rescale(1)->1 is not recorded)
    assert len(tr.rescale_history) == 3
    assert all(dt > 0 for _, _, dt in tr.rescale_history)


def test_measured_rescale_costs_exclude_kills():
    tr = object.__new__(ElasticTrainer)   # only rescale_history is read
    tr.rescale_history = [
        (4, 2, 0.2), (2, 1, 0.4),   # true downscales
        (3, 0, 50.0),               # kill: must be excluded from r_dw
        (1, 2, 0.6), (2, 4, 1.0),   # true upscales
        (0, 2, 40.0),               # unpark: must be excluded from r_up
    ]
    r_up, r_dw = tr.measured_rescale_costs()
    assert r_dw == pytest.approx(0.3)
    assert r_up == pytest.approx(0.8)


def test_measured_rescale_costs_defaults_without_history():
    tr = object.__new__(ElasticTrainer)
    tr.rescale_history = [(0, 1, 12.0), (1, 0, 9.0)]   # only park/unpark
    assert tr.measured_rescale_costs() == (0.5, 0.1)


def test_elastic_rescale_rejects_oversubscription():
    tr = small_trainer(seed=2)
    with pytest.raises(ValueError):
        tr.rescale(2)                     # the CPU counts as one device


def test_rescale_beyond_one_card_is_the_distribution_slice(monkeypatch):
    tr = small_trainer(seed=2)
    monkeypatch.setattr(tr, "_n_devices", lambda: 4)
    with pytest.raises(NotImplementedError, match="distribution slice"):
        tr.rescale(2)
    assert tr.n_nodes == 0 and tr.rescale_history == []


def test_park_moves_state_to_the_host_and_back():
    tr = small_trainer(seed=3)
    tr.rescale(1)
    tr.train_step()
    mu = {n: t.clone() for n, t in tr.opt_state.mu.items()}
    tr.rescale(0)
    assert all(p.device.type == "cpu" for p in tr.params.values())
    tr.rescale(1)
    assert int(tr.opt_state.step) == 1
    for n, t in tr.opt_state.mu.items():
        assert torch.equal(t, mu[n])


# ---------------------------------------------------------------------------
# Three steps against the JAX trainer, from one JAX checkpoint
# ---------------------------------------------------------------------------


def test_three_steps_match_the_jax_trainer(tmp_path):
    jtr = jax_small_trainer(seed=4)
    jtr.rescale(1)
    jtr.train_step()                      # non-zero moments to carry over
    mgr = JaxCheckpointManager(str(tmp_path))
    jtr.save_checkpoint(mgr)

    tr = small_trainer(seed=4)            # the same data; other weights
    assert tr.restore_checkpoint(CheckpointManager(str(tmp_path))) == 1
    tr.pipeline.restore(jtr.pipeline.state())
    tr.rescale(1)
    assert int(tr.opt_state.step) == 1

    for _ in range(3):
        want, got = jtr.train_step(), tr.train_step()
        assert got.step == want.step and got.samples == want.samples
        assert abs(got.loss - want.loss) <= 1e-4 * abs(want.loss)
    flat = {torch_name(jax.tree_util.keystr(p)): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(
                jtr.params)[0]}
    assert set(flat) == set(tr.params)
    for name, p in tr.params.items():
        _close(p.detach().numpy(), flat[name])


# ---------------------------------------------------------------------------
# Checkpoints, both ways
# ---------------------------------------------------------------------------


def test_port_checkpoint_reads_in_the_jax_package(tmp_path):
    tr = small_trainer(seed=6)
    tr.rescale(1)
    tr.train_step()
    path = tr.save_checkpoint(CheckpointManager(str(tmp_path)),
                              meta={"arch": "gemma-2b-smoke"})
    jtr = jax_small_trainer(seed=7)
    like = {"params": jtr.params, "opt_state": jtr.opt_state}
    tree, meta = jax_load_checkpoint(path, like)
    assert meta == {"arch": "gemma-2b-smoke", "step": 1}
    assert int(tree["opt_state"].step) == 1
    for p, leaf in jax.tree_util.tree_flatten_with_path(tree["params"])[0]:
        name = torch_name(jax.tree_util.keystr(p))
        np.testing.assert_array_equal(np.asarray(leaf),
                                      tr.params[name].detach().numpy())
    mu = {torch_name(jax.tree_util.keystr(p)): np.asarray(leaf)
          for p, leaf in jax.tree_util.tree_flatten_with_path(
              tree["opt_state"].mu)[0]}
    for name, t in tr.opt_state.mu.items():
        np.testing.assert_array_equal(mu[name], t.numpy())


def test_bf16_npz_is_the_jax_package_format(tmp_path):
    vals = np.random.RandomState(8).randn(3, 5).astype(np.float32)
    t = torch.from_numpy(vals).to(torch.bfloat16)
    save_checkpoint(str(tmp_path / "pt"), {"w": t, "n": {"s": t[0].float()}})
    jax_save_checkpoint(str(tmp_path / "jx"),
                        {"w": jax.numpy.asarray(vals, jax.numpy.bfloat16),
                         "n": {"s": jax.numpy.asarray(t[0].float().numpy())}})
    a, b = np.load(tmp_path / "pt.npz"), np.load(tmp_path / "jx.npz")
    assert sorted(a.files) == sorted(b.files) == ["['n']['s']", "['w']"]
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    back, _ = load_checkpoint(str(tmp_path / "jx"), {"w": t, "n": {"s": t}})
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], t)


def test_manager_keeps_the_newest_and_falls_back_past_a_corrupt_one(
        tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(4.0), "b": (torch.ones(2, dtype=torch.int32),)}
    for step in (1, 2, 3):
        mgr.save({"a": tree["a"] * step, "b": tree["b"]}, step=step)
    assert mgr.steps() == [2, 3]
    with open(os.path.join(str(tmp_path), "ckpt_000000000003.npz"),
              "r+b") as f:
        f.seek(100)
        f.write(b"\x00garbage\x00")
    got, meta, step = mgr.load_latest_good(tree)
    assert step == 2 and meta == {"step": 2}
    assert torch.equal(got["a"], tree["a"] * 2)
    assert torch.equal(got["b"][0], tree["b"][0])
    with open(os.path.join(str(tmp_path), "ckpt_000000000002.npz"),
              "r+b") as f:
        f.seek(100)
        f.write(b"\x00garbage\x00")
    with pytest.raises(CorruptCheckpointError):
        mgr.load_latest_good(tree)


def test_snapshot_takes_host_copies():
    t = torch.ones(3)
    snap = Snapshot.take({"x": t}, step=4)
    t.add_(1)
    assert snap.step == 4 and float(snap.tree["x"][0]) == 1.0
    assert snap.restore()["x"] is not snap.tree["x"]


# ---------------------------------------------------------------------------
# BFTrainerRuntime against the JAX runtime
# ---------------------------------------------------------------------------


def test_runtime_reproduces_the_jax_runtime():
    def run(rt_cls, managed_cls, alloc_cls, curve, frags_fn, to_events,
            make):
        frags = frags_fn(n_nodes=6, duration=24 * 3600.0, seed=5)
        managed = [managed_cls(id=i, trainer=make(seed=10 + i),
                               curve=curve(f"t{i}", 100.0, 0.2),
                               n_min=1, n_max=1, target_steps=3)
                   for i in range(2)]
        return rt_cls(managed, alloc_cls("fast"), t_fwd=120.0).run(
            to_events(frags), time_scale=1.0, max_steps_per_interval=2,
            measure_rescale_costs=False)

    ops.reset_launches()
    got = run(BFTrainerRuntime, ManagedTrainer, MILPAllocator, amdahl_curve,
              generate_summit_like, fragments_to_events, small_trainer)
    assert not any(ops.LAUNCHES.values())
    want = run(JaxRuntime, JaxManagedTrainer, JaxMILPAllocator,
               jax_amdahl_curve, jax_generate_summit_like,
               jax_fragments_to_events, jax_small_trainer)
    assert got.events == want.events > 0
    assert got.steps == want.steps and sum(got.steps.values()) > 0
    assert got.samples == want.samples
    assert got.rescales == want.rescales
    for mid, ls in got.losses.items():
        assert len(ls) == len(want.losses[mid])
        assert all(np.isfinite(v) for v in ls)


# ---------------------------------------------------------------------------
# Defaults
# ---------------------------------------------------------------------------


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device runs")


def test_trainer_defaults_to_cuda_and_raises_without_card():
    _no_card()
    model = Model(get_arch("gemma-2b-smoke"), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticTrainer(model)


def test_train_cli_defaults_to_cuda_and_raises_without_card():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])


def test_train_cli_runs_on_cpu_and_writes_a_checkpoint(tmp_path, capsys):
    ops.reset_launches()
    ckpt = str(tmp_path / "final")
    tr = train.main(["--device", "cpu", "--steps", "2", "--per-node-batch",
                     "2", "--seq", "16", "--checkpoint", ckpt])
    assert tr.step_count == 2
    assert not any(ops.LAUNCHES.values())
    out = capsys.readouterr().out
    assert "device=cpu" in out and "2 steps in" in out
    with np.load(ckpt + ".npz") as data:
        assert "['blocks'][0]['mixer']['wq']" in data.files


def test_train_cli_elastic_runs_on_cpu(capsys):
    tr = train.main(["--device", "cpu", "--steps", "2", "--per-node-batch",
                     "2", "--seq", "16", "--elastic"])
    assert tr.step_count == 2
    assert "elastic run: 2 steps" in capsys.readouterr().out
