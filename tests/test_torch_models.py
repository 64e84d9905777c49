"""The PyTorch port's gemma-2b serving path against the JAX package, on
the CPU, at the smoke size, on the same (bridged) weights, with a serving
model (``trainable=False``).

Tolerance: fp32 throughout, so the two packages do the same arithmetic
and differ only in the order XLA and torch's CPU kernels sum the matrix
products: logits agree to 1e-4 of their largest magnitude (1e-4 absolute
when that is below 1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint
from repro.configs import get_arch as jax_get_arch
from repro.models import build_model
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_flat, torch_name
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import Model, n_params
from repro_torch.models import attention as pt_attn
from repro_torch.models import layers as pt_layers
from repro_torch.serving import ServeEngine

ARCH = "gemma-2b-smoke"
TOL = 1e-4


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1.0)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, (err, scale)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, torch model) on the same weights."""
    cfg = jax_get_arch(ARCH)
    jm = build_model(cfg, remat=False)
    params = jm.init(jax.random.key(0))
    tm = Model(get_arch(ARCH), device="cpu", trainable=False)
    tm.load_state_dict(params_from_flat(_flat(params)))
    return jm, params, tm


def _tokens(b, s, seed=0, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(np.int32)


def test_config_copy_matches_jax():
    for name in ("gemma-2b", "gemma-2b-smoke"):
        assert (dataclasses.asdict(get_arch(name))
                == dataclasses.asdict(jax_get_arch(name)))


def test_n_params_matches_jax():
    want = build_model(jax_get_arch("gemma-2b")).n_params()
    assert n_params(get_arch("gemma-2b")) == want == 2_506_172_416


def test_state_dict_names_are_the_jax_keystr_paths(pair):
    _, params, tm = pair
    flat = _flat(params)
    assert {torch_name(k) for k in flat} == set(tm.state_dict())
    for k, v in flat.items():
        assert tuple(tm.state_dict()[torch_name(k)].shape) == v.shape


@pytest.mark.parametrize("fn", ["apply_rope", "geglu", "rms_norm"])
def test_primitive_matches_jax(fn):
    rng = np.random.RandomState(1)
    if fn == "apply_rope":
        x = rng.randn(2, 10, 4, 32).astype(np.float32)
        pos = np.arange(3, 13, dtype=np.int32)
        want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
        got = pt_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                   1e4)
    elif fn == "geglu":
        g, u = rng.randn(2, 3, 64, 48).astype(np.float32)
        want = jax_layers.geglu(jnp.asarray(g), jnp.asarray(u))
        got = pt_layers.geglu(torch.from_numpy(g), torch.from_numpy(u))
    else:
        x = rng.randn(3, 7, 128).astype(np.float32)
        s = (rng.randn(128) * 0.1).astype(np.float32)
        want = jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(s))
        got = pt_layers.rms_norm(torch.from_numpy(x), torch.from_numpy(s))
    _close(got, want, 2e-6)


def test_attn_apply_matches_jax(pair):
    jm, params, tm = pair
    cfg = jm.cfg
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 24, cfg.d_model) * 0.5).astype(np.float32)
    p_jax = jax.tree.map(lambda a: a[0], params["blocks"][0]["mixer"])
    want = jax_attn.attn_apply(p_jax, jnp.asarray(x), cfg=cfg, causal=True,
                               window=0)
    got = pt_attn.attn_apply(tm.blocks[0].layers()[0]["mixer"],
                             torch.from_numpy(x), cfg=tm.cfg, causal=True,
                             window=0)
    _close(got, want)


def test_forward_logits_match_jax(pair):
    jm, params, tm = pair
    toks = _tokens(2, 20)
    want, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    got, _ = tm({"tokens": torch.from_numpy(toks)})
    _close(got, want)


def _jax_prefill(jm, params, toks, cache_len):
    return jax.jit(lambda p, b: jm.prefill(p, b, cache_len=cache_len))(
        params, {"tokens": jnp.asarray(toks)})


def test_prefill_logits_and_cache_match_jax(pair):
    jm, params, tm = pair
    toks = _tokens(2, 16, seed=3)
    want_logits, want_cache = _jax_prefill(jm, params, toks, 32)
    got_logits, got_cache = tm.prefill({"tokens": torch.from_numpy(toks)},
                                       cache_len=32)
    _close(got_logits, want_logits)
    for name in ("k", "v"):
        want = np.asarray(want_cache[0]["kv"][name].astype(jnp.float32))
        got = got_cache[0]["kv"][name]
        assert got.dtype == torch.bfloat16
        # both round the same fp32 values to bf16: at most one bf16 ulp
        _close(got.float(), want, 2 ** -7)


def test_decode_steps_match_jax(pair):
    jm, params, tm = pair
    toks = _tokens(2, 24, seed=4)
    s0, cache_len = 16, 32
    _, jc = _jax_prefill(jm, params, toks[:, :s0], cache_len)
    jc = jax.tree.map(lambda a: a.astype(jnp.float32), jc)
    _, tc = tm.prefill({"tokens": torch.from_numpy(toks[:, :s0])},
                       cache_len=cache_len)
    tc = tuple({"kv": {n: t.float() for n, t in c["kv"].items()}} for c in tc)
    jdec = jax.jit(jm.decode_step)
    for pos in range(s0, s0 + 8):            # teacher-forced
        tok = toks[:, pos:pos + 1]
        want, jc = jdec(params, jc, jnp.asarray(tok), jnp.int32(pos))
        got, tc = tm.decode_step(tc, torch.from_numpy(tok), pos)
        _close(got, want)


def test_serve_engine_greedy_tokens_match_jax(pair):
    jm, params, tm = pair
    toks = _tokens(2, 16, seed=5)
    want = JaxServeEngine(jm, params, max_len=32).generate(
        {"tokens": jnp.asarray(toks)}, 8)
    ops.reset_launches()
    got = ServeEngine(tm, max_len=32, device="cpu").generate(
        {"tokens": toks}, 8)
    assert got.tokens.shape == (2, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES


def test_jax_checkpoint_loads_into_port(pair, tmp_path):
    jm, params, _ = pair
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, params, meta={"step": 1})
    tm = Model(get_arch(ARCH), device="cpu", trainable=False,
               generator=torch.Generator().manual_seed(9))
    with np.load(path + ".npz") as data:
        tm.load_state_dict(params_from_flat(dict(data)))
    toks = _tokens(1, 12, seed=6)
    want, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    got, _ = tm({"tokens": torch.from_numpy(toks)})
    _close(got, want)
