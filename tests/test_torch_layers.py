"""The port's layers and attention functions against the JAX package's, on
inputs drawn from a numpy seed.

f32 inputs: both sides run the same algorithm and differ only in summation
order, so the bound is 1e-5 (1e-4 where a long f32 reduction feeds it).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.models import attention as JA
from repro.models import layers as JL
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("rope_dim,D,theta", [(64, 64, 5e5), (16, 64, 1e4)])
def test_rope(rope_dim, D, theta):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 12, 3, D)
    pos = np.arange(5, 17)
    jc, js = JL.rope_angles(jnp.asarray(pos), rope_dim, theta)
    tc, ts = L.rope_angles(torch.from_numpy(pos), rope_dim, theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    jx, tx = _both(x)
    np.testing.assert_allclose(
        L.apply_rope(tx, tc, ts, rope_dim).numpy(),
        np.asarray(JL.apply_rope(jx, jc, js, rope_dim)), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_apply(act):
    rng = np.random.default_rng(1)
    d, f = 32, 64
    x = _rand(rng, 2, 5, d)
    w = {"w_up": _rand(rng, d, f, scale=d ** -0.5),
         "w_down": _rand(rng, f, d, scale=f ** -0.5)}
    if act == "silu":
        w["w_gate"] = _rand(rng, d, f, scale=d ** -0.5)
    mlp = L.MLP(d, f, act, dtype=torch.float32)
    mlp.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    ref = JL.mlp_apply(jnp.asarray(x),
                       {k: jnp.asarray(v) for k, v in w.items()}, act)
    with torch.no_grad():
        out = L.mlp_apply(torch.from_numpy(x), mlp, act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_rmsnorm_bf16_activations_f32_weight():
    rng = np.random.default_rng(2)
    x = _rand(rng, 3, 7, 96)
    w = _rand(rng, 96)
    ref = JL.rmsnorm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), 1e-5)
    out = L.rmsnorm(torch.from_numpy(x).to(torch.bfloat16),
                    torch.from_numpy(w), 1e-5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


ATTN_CASES = [
    # B, Sq, Sk, H, Kv, D, causal, softcap
    (2, 32, 32, 4, 2, 16, True, 0.0),
    (1, 24, 40, 6, 2, 8, False, 0.0),
    (2, 32, 32, 2, 1, 16, False, 0.0),
    (1, 32, 32, 4, 4, 16, True, 20.0),
]


@pytest.mark.parametrize("B,Sq,Sk,H,Kv,D,causal,softcap", ATTN_CASES)
def test_full_and_blocked_attention(B, Sq, Sk, H, Kv, D, causal, softcap):
    rng = np.random.default_rng(3)
    q, k, v = (_rand(rng, B, Sq, H, D), _rand(rng, B, Sk, Kv, D),
               _rand(rng, B, Sk, Kv, D))
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    kw = dict(causal=causal, softcap=softcap)
    ref = np.asarray(JL.full_attention(jq, jk, jv, **kw))
    np.testing.assert_allclose(L.full_attention(tq, tk, tv, **kw).numpy(),
                               ref, **TOL)
    jb = JL.blocked_attention(jq, jk, jv, block_q=8, block_k=16, **kw)
    tb = L.blocked_attention(tq, tk, tv, block_q=8, block_k=16, **kw)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)
    np.testing.assert_allclose(tb.numpy(), ref, **TOL)


@pytest.mark.parametrize("S,pos,dtype", [(64, 0, "float32"),
                                         (64, 37, "bfloat16"),
                                         (1536, 1100, "bfloat16")])
def test_decode_partial_softmax(S, pos, dtype):
    """The single-shard branch of sharded_decode_attention; S = 1536 takes
    the chunk search (1024 -> 768) over two chunks."""
    rng = np.random.default_rng(4)
    B, H, Kv, D = 2, 4, 2, 16
    q = _rand(rng, B, 1, H, D)
    kc, vc = _rand(rng, B, S, Kv, D), _rand(rng, B, S, Kv, D)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    ref = JA.sharded_decode_attention(jnp.asarray(q, jdt),
                                      jnp.asarray(kc, jnp.bfloat16),
                                      jnp.asarray(vc, jnp.bfloat16), pos)
    out = A.sharded_decode_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kc).to(torch.bfloat16),
        torch.from_numpy(vc).to(torch.bfloat16), pos)
    assert out.dtype == tdt
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def test_gqa_apply_blocked_branch():
    """Sq * Sk > 1024**2 switches both packages to blocked attention."""
    kw = dict(arch_id="t", family="dense", n_layers=1, d_model=16,
              n_heads=2, n_kv_heads=1, d_ff=32, vocab_size=8,
              rope_theta=5e5)
    jcfg, cfg = JaxArchConfig(**kw), ArchConfig(**kw)
    rng = np.random.default_rng(5)
    S = 1032
    x = _rand(rng, 1, S, 16)
    w = {"wq": _rand(rng, 16, 16, scale=0.25),
         "wk": _rand(rng, 16, 8, scale=0.25),
         "wv": _rand(rng, 16, 8, scale=0.25),
         "wo": _rand(rng, 16, 16, scale=0.25)}
    p = A.GQA(cfg, dtype=torch.float32)
    p.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    pos = np.arange(S)
    ref = JA.gqa_apply(jnp.asarray(x), {k: jnp.asarray(v)
                                         for k, v in w.items()}, jcfg,
                       positions=jnp.asarray(pos))
    with torch.no_grad():
        out = A.gqa_apply(torch.from_numpy(x), p, cfg,
                          positions=torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_config_fields_are_the_jax_packages():
    """The port's ArchConfig is a subset of the JAX one, same defaults."""
    ref = {f.name: f for f in dataclasses.fields(JaxArchConfig)}
    for f in dataclasses.fields(ArchConfig):
        assert f.name in ref
        assert f.default == ref[f.name].default, f.name
