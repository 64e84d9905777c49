"""The PyTorch port's training path against the JAX package, on the CPU:
``Model.loss`` and its gradients, AdamW, the LR schedules and the data
pipeline.

Tolerances: the model runs in fp32 on bridged weights, so the two
packages differ only in the order sums are taken: the loss and every
parameter's gradient agree to 1e-4 of the leaf's largest magnitude.
One AdamW step agrees to 1e-6 of each leaf's largest value (fp32
arithmetic in the same order, up to the order of the global-norm sum).
The schedules agree to 1e-7 and the pipeline's batches bit for bit.
In a bf16 model the JAX ``_logits`` rounds the logits to bf16 before
the fp32 loss and the port's ``ce_loss`` does not; that case is held at
2e-2 of the loss.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data import DataConfig as JaxDataConfig
from repro.data import TokenPipeline as JaxTokenPipeline
from repro.models import build_model
from repro.optim import AdamW as JaxAdamW
from repro.optim import linear_scaling as jax_linear_scaling
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro_torch.bridge import params_from_flat, torch_name
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.optim import AdamW, linear_scaling, warmup_cosine

ARCH = "gemma-2b-smoke"
B, S = 2, 48


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, (err, scale)


@pytest.fixture(scope="module")
def jax_loss_and_grads():
    """JAX ``value_and_grad(Model.loss)`` on the smoke model (remat off:
    remat changes memory, not values)."""
    jm = build_model(jax_get_arch(ARCH), remat=False)
    params = jm.init(jax.random.key(0))
    toks = np.random.RandomState(0).randint(0, 512, (B, S)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    loss, grads = jax.value_and_grad(jm.loss)(params, batch)
    return params, toks, float(loss), {
        torch_name(k): v for k, v in _flat(grads).items()}


def _torch_model(params, **kw) -> Model:
    tm = Model(get_arch(ARCH), device="cpu", **kw)
    tm.load_state_dict(params_from_flat(_flat(params)))
    return tm


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_jax(jax_loss_and_grads, remat):
    params, toks, want_loss, want_grads = jax_loss_and_grads
    tm = _torch_model(params, remat=remat)
    t = torch.from_numpy(toks).long()
    ops.reset_launches()
    loss = tm.loss({"tokens": t, "labels": t})
    loss.backward()
    assert not any(ops.LAUNCHES.values())       # the CPU path: plain versions
    _close(loss.detach().numpy(), want_loss, 1e-4)
    grads = dict(tm.named_parameters())
    assert set(grads) == set(want_grads)
    for name, p in grads.items():
        _close(p.grad.numpy(), want_grads[name], 1e-4)


def test_bf16_loss_matches_jax_within_the_logit_rounding():
    jm = build_model(jax_get_arch(ARCH), remat=False, dtype=jnp.bfloat16)
    params = jm.init(jax.random.key(1))
    toks = np.random.RandomState(1).randint(0, 512, (B, S)).astype(np.int32)
    want = float(jm.loss(params, {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(toks)}))
    tm = Model(get_arch(ARCH), device="cpu", dtype=torch.bfloat16)
    tm.load_state_dict(params_from_flat(_flat(params)))
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        got = float(tm.loss({"tokens": t, "labels": t}))
    assert abs(got - want) <= 2e-2 * abs(want)


def test_loss_refuses_a_final_logit_softcap():
    cfg = dataclasses.replace(get_arch(ARCH), final_logit_softcap=30.0)
    tm = Model(cfg, device="cpu")
    t = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="softcap"):
        tm.loss({"tokens": t, "labels": t})


def test_trainable_flag_and_stacked_gradients():
    frozen = Model(get_arch(ARCH), device="cpu", trainable=False)
    assert not any(p.requires_grad for p in frozen.parameters())
    tm = Model(get_arch(ARCH), device="cpu")
    assert all(p.requires_grad for p in tm.parameters())
    t = torch.from_numpy(np.random.RandomState(2).randint(0, 512, (1, 9)))
    tm.loss({"tokens": t, "labels": t}).backward()
    wq = tm.blocks[0].mixer.wq
    assert wq.grad.shape == wq.shape                  # one stacked gradient
    assert all(float(g.abs().sum()) > 0 for g in wq.grad)   # every layer


# ---------------------------------------------------------------------------
# AdamW and the schedules
# ---------------------------------------------------------------------------


def _opt_trees(seed=3):
    rng = np.random.RandomState(seed)
    shapes = {"embed": (16, 8), "final_norm": (8,),
              "blocks": ({"w": (2, 8, 12), "norm": (2, 8)},)}
    params = jax.tree.map(lambda s: (rng.randn(*s) * 0.5).astype(np.float32),
                          shapes, is_leaf=lambda s: isinstance(s, tuple)
                          and all(isinstance(i, int) for i in s))
    grads = jax.tree.map(lambda a: (rng.randn(*a.shape) * 3).astype(
        np.float32), params)
    return params, grads


def _named(tree) -> dict:
    return {torch_name(k): torch.from_numpy(v.copy())
            for k, v in _flat(tree).items()}


def test_adamw_steps_match_jax_with_clipping():
    params, grads = _opt_trees()
    opt, jopt = AdamW(lr=1e-2), JaxAdamW(lr=1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jopt.init(jp)
    tp = _named(params)
    tst = opt.init(tp)
    gnorm = np.sqrt(sum(float(np.sum(g ** 2)) for g in jax.tree.leaves(grads)))
    assert gnorm > opt.grad_clip                     # clipping is active
    for lr_scale in (1.0, 0.5):
        jp, jst = jopt.update(jax.tree.map(jnp.asarray, grads), jst, jp,
                              lr_scale=jnp.float32(lr_scale))
        tp, tst = opt.update(_named(grads), tst, tp,
                             lr_scale=torch.tensor(lr_scale))
    assert int(tst.step) == int(jst.step) == 2
    for want, got in ((jp, tp), (jst.mu, tst.mu), (jst.nu, tst.nu)):
        for name, w in _named(want).items():
            _close(got[name].numpy(), w.numpy(), 1e-6)


def test_adamw_keeps_a_bf16_parameter_bf16():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    opt = AdamW(lr=0.1)
    _, st = opt.update({"w": torch.ones(4, dtype=torch.bfloat16)},
                       opt.init(p), p)
    assert p["w"].dtype == torch.bfloat16 and st.mu["w"].dtype == torch.float32
    assert float(p["w"][0]) < 1.0


@pytest.mark.parametrize("step", [0, 1, 7, 19, 20, 21, 500, 9999, 10000,
                                  20000])
def test_warmup_cosine_matches_jax(step):
    for kw in (dict(warmup_steps=20, total_steps=10_000),
               dict(warmup_steps=2, total_steps=50, base_lr=3.0,
                    min_frac=0.2)):
        want = float(jax_warmup_cosine(jnp.int32(step), **kw))
        got = float(warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw))
        assert abs(got - want) <= 1e-7 * max(abs(want), 1.0)


def test_linear_scaling_matches_jax():
    for n, base in ((1, 1), (3, 1), (8, 2), (100, 1)):
        assert linear_scaling(n, base) == jax_linear_scaling(n, base)


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------


def test_pipeline_batches_are_bit_identical_across_a_rescale():
    kw = dict(vocab_size=512, seq_len=48, per_node_batch=2, seed=7)
    pt, pj = TokenPipeline(DataConfig(**kw)), JaxTokenPipeline(
        JaxDataConfig(**kw))
    for n_nodes in (1, 2, 1, 3):
        a, b = pt.next_batch(n_nodes), pj.next_batch(n_nodes)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert pt.state() == pj.state() == {"consumed": 14}
    fresh = TokenPipeline(DataConfig(**kw))
    fresh.restore(pj.state())
    np.testing.assert_array_equal(fresh.next_batch(1)["tokens"],
                                  pj.next_batch(1)["tokens"])
