"""The port's hybrid ZambaLM (zamba2) against the JAX package on shared
weights: one Mamba2 block's prefill and decode, the reduced model's prefill
forward and teacher-forced decode, and the port's own decode against its
prefill.

Weights come from the JAX init (key 3) and cross through
``params_from_jax``; tokens and activations come from numpy seeds, so both
sides see the same inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduced_config as jax_reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.models import ssm as SSM
from repro_torch.models.registry import build_model, get_config, \
    reduced_config
from repro_torch.models.zamba import ZambaLM

ARCH = "zamba2-1.2b"
B, S = 2, 16


@pytest.fixture(scope="module")
def jax_side():
    cfg = jax_reduced_config(jax_get_config(ARCH))
    model = jax_build_model(cfg, remat=False)
    return model, model.init(jax.random.key(3))


def _cast(params, dtype):
    """Matmul and conv weights to ``dtype``; the f32 leaves stay f32."""
    return jax.tree.map(
        lambda a: a.astype(dtype) if a.dtype == jnp.bfloat16 else a, params)


def _port(params, dtype):
    model = build_model(reduced_config(get_config(ARCH)), device="cpu",
                        dtype=dtype, seed=None)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          "hybrid"))
    return model


def _tokens(seed=0, S=S):
    return np.random.default_rng(seed).integers(0, 512, (B, S))


def test_reduced_config_matches_jax():
    ours = dataclasses.asdict(reduced_config(get_config(ARCH)))
    ref = dataclasses.asdict(jax_reduced_config(jax_get_config(ARCH)))
    for key, val in ours.items():
        assert ref[key] == val, key
    assert (ours["n_layers"], ours["hybrid_attn_every"]) == (8, 3)


def test_full_config_is_the_published_one():
    cfg = get_config(ARCH)
    ref = dataclasses.asdict(jax_get_config(ARCH))
    for key, val in dataclasses.asdict(cfg).items():
        assert ref[key] == val, key
    model = ZambaLM(cfg, device="meta")
    assert (model.n_super, model.n_tail) == (6, 2)
    assert cfg.ssm.d_inner(cfg.d_model) == 4096
    assert cfg.ssm.n_heads(cfg.d_model) == 64


# ------------------------------------------------------------ one block

@pytest.fixture(scope="module")
def one_block():
    """One Mamba2 block of the reduced config, f32 weights from the JAX
    init, on both sides."""
    jcfg = jax_reduced_config(jax_get_config(ARCH))
    p = _cast(JS.mamba_init(jax.random.key(4), jcfg), jnp.float32)
    # a nonzero A_log and a norm weight other than ones, so both count
    rng = np.random.default_rng(12)
    p["A_log"] = jnp.asarray(rng.standard_normal(p["A_log"].shape) * 0.3,
                             jnp.float32)
    p["norm"]["w"] = jnp.asarray(1 + 0.1 * rng.standard_normal(
        p["norm"]["w"].shape), jnp.float32)
    cfg = reduced_config(get_config(ARCH))
    block = SSM.Mamba(cfg, dtype=torch.float32)
    block.load_state_dict(params_from_jax(jax.tree.map(np.asarray, p)))
    return jcfg, p, cfg, block


def test_mamba_apply_matches_jax(one_block):
    jcfg, p, cfg, block = one_block
    x = np.random.default_rng(13).standard_normal((B, 64, 128)).astype(
        np.float32)
    ref = JS.mamba_apply(jnp.asarray(x), p, jcfg)
    with torch.no_grad():
        out = SSM.mamba_apply(torch.from_numpy(x), block, cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_mamba_decode_matches_jax(one_block):
    """Step by step from an empty cache; the conv states are bf16 on both
    sides (the JAX cache's dtype), so a 1-ulp f32 difference can round to
    the neighbouring bf16 value: the cache is compared at bf16's
    resolution, the outputs at 1e-4."""
    jcfg, p, cfg, block = one_block
    x = np.random.default_rng(14).standard_normal((B, 8, 128)).astype(
        np.float32)
    jcache = jax.tree.map(lambda a: a[0], JS.mamba_make_cache(jcfg, 1, B))
    tcache = {k: v[0] for k, v in SSM.mamba_make_cache(cfg, 1, B).items()}
    for t in range(x.shape[1]):
        ref, jcache = JS.mamba_decode(jnp.asarray(x[:, t:t + 1]), p, jcfg,
                                      jcache)
        with torch.no_grad():
            out, _ = SSM.mamba_decode(torch.from_numpy(x[:, t:t + 1]),
                                      block, cfg, tcache)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {t}")
    for key, val in tcache.items():
        assert val.dtype == (torch.float32 if key == "state"
                             else torch.bfloat16), key
        np.testing.assert_allclose(val.float().numpy(),
                                   np.asarray(jcache[key], np.float32),
                                   rtol=1e-2, atol=1e-2, err_msg=key)


# ---------------------------------------------------------- whole model

def _forward_pair(jax_side, jdtype, tdtype, S=64):
    model, params = jax_side
    params = _cast(params, jdtype)
    toks = _tokens(S=S)
    a, _ = jax.jit(model.forward_logits)(
        params, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        b = _port(params, tdtype).forward_logits(torch.from_numpy(toks))
    assert b.dtype == tdtype and b.shape == a.shape
    return np.asarray(a, np.float32), b.float().numpy()


def test_forward_logits_f32(jax_side):
    """Same algorithm in f32 (two chunks of 32 per sequence): only
    summation order differs."""
    a, b = _forward_pair(jax_side, jnp.float32, torch.float32)
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def test_forward_logits_bf16(jax_side):
    """bf16 logits on both sides, rounded at other places in the two
    frameworks: the bound of tests/test_decode_consistency.py."""
    a, b = _forward_pair(jax_side, jnp.bfloat16, torch.bfloat16)
    diff = np.abs(a - b)
    assert float(np.quantile(diff, 0.999)) < 0.2
    assert float(diff.max()) < 0.5
    assert (a.argmax(-1) == b.argmax(-1)).mean() > 0.9


@pytest.mark.parametrize("jdtype,tdtype,atol", [
    # the conv and KV caches are bf16 on both sides: a 1-ulp f32 difference
    # in a new entry can round to the neighbouring bf16 value
    (jnp.float32, torch.float32, 2e-3),
    (jnp.bfloat16, torch.bfloat16, 5e-2),
])
def test_decode_step_teacher_forced(jax_side, jdtype, tdtype, atol):
    model, params = jax_side
    params = _cast(params, jdtype)
    port = _port(params, tdtype)
    toks = _tokens(1)
    cache, tcache = model.init_cache(B, S), port.init_cache(B, S)
    assert tcache["attn_k"].shape == (2, B, S, 4, 32)
    assert tcache["mamba"]["state"].shape == (2, 3, B, 8, 32, 16)
    assert tcache["tail"]["conv_x"].dtype == torch.bfloat16
    step = jax.jit(model.decode_step)
    for t in range(S):
        la, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1],
                                                    jnp.int32), jnp.int32(t))
        with torch.no_grad():
            lb, tcache = port.decode_step(
                tcache, torch.from_numpy(toks[:, t:t + 1]), t)
        assert lb.dtype == tdtype
        np.testing.assert_allclose(lb.float().numpy(),
                                   np.asarray(la, np.float32), rtol=0,
                                   atol=atol, err_msg=f"step {t}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_matches_prefill_forward(dtype):
    """The port's own consistency check, as tests/test_decode_consistency.py
    makes it for the JAX package, over two chunks of the scan."""
    port = build_model(reduced_config(get_config(ARCH)), device="cpu",
                       dtype=dtype, seed=3)
    toks = torch.from_numpy(_tokens(2, S=64))
    with torch.no_grad():
        full = port.forward_logits(toks).float()
        cache = port.init_cache(B, 64)
        dec = torch.cat([port.decode_step(cache, toks[:, t:t + 1], t)[0]
                         for t in range(64)], dim=1).float()
    diff = (full - dec).abs().numpy()
    assert float(np.quantile(diff, 0.999)) < 0.2
    assert float(diff.max()) < 0.5
    assert (full.argmax(-1) == dec.argmax(-1)).float().mean() > 0.9


def test_seeded_init_is_deterministic_and_finite():
    cfg = reduced_config(get_config(ARCH))
    a = build_model(cfg, device="cpu", seed=5)
    b = build_model(cfg, device="cpu", seed=5)
    for (name, pa), pb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(pa, pb), name
        assert torch.isfinite(pa.float()).all(), name
    blk = a.blocks[0][0].mamba
    assert torch.equal(blk.A_log, torch.zeros(8))
    torch.testing.assert_close(
        blk.dt_bias, torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, 8))))
