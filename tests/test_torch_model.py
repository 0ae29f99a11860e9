"""The port's dense TransformerLM against the JAX package on shared weights:
the weight bridge, the prefill forward and teacher-forced decode.

Weights come from the JAX init and cross through ``params_from_jax``;
tokens come from a numpy seed, so both sides see the same inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.registry import build_model as jax_build_model
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduced_config as jax_reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.models.registry import build_model, get_config, \
    reduced_config

ARCH = "llama3.2-1b"
B, S = 2, 16


@pytest.fixture(scope="module")
def jax_side():
    cfg = jax_reduced_config(jax_get_config(ARCH))
    model = jax_build_model(cfg, remat=False)
    return model, model.init(jax.random.key(3))


def _cast(params, dtype):
    """Matmul weights to ``dtype``; the f32 norm weights stay f32."""
    return jax.tree.map(
        lambda a: a.astype(dtype) if a.dtype == jnp.bfloat16 else a, params)


def _port(params, dtype):
    model = build_model(reduced_config(get_config(ARCH)), device="cpu",
                        dtype=dtype, seed=None)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return model


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S))


def test_reduced_config_matches_jax():
    import dataclasses
    ours = dataclasses.asdict(reduced_config(get_config(ARCH)))
    ref = dataclasses.asdict(jax_reduced_config(jax_get_config(ARCH)))
    for key, val in ours.items():
        assert ref[key] == val, key


def test_untied_embeddings_are_not_ported():
    import dataclasses
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)),
                              tie_embeddings=False)
    with pytest.raises(NotImplementedError, match="untied"):
        build_model(cfg, device="cpu")


def _hybrid_pairs(state, tree):
    """Sample (port tensor, JAX leaf) pairs of the hybrid tree: blocks
    stacked over (n_super, every), tail over n_tail, shared_attn as is."""
    n_super, every = tree["blocks"]["mamba"]["wz"].shape[:2]
    n_tail = tree["tail"]["mamba"]["wz"].shape[0]
    pairs = [(state["shared_attn.attn.wq"], tree["shared_attn"]["attn"]["wq"]),
             (state["shared_attn.ffn_norm.w"],
              tree["shared_attn"]["ffn_norm"]["w"])]
    for i in range(n_super):
        for j in range(every):
            pairs += [(state[f"blocks.{i}.{j}.mamba.{k}"],
                       tree["blocks"]["mamba"][k][i, j])
                      for k in ("wz", "conv_x", "A_log", "dt_bias")]
            pairs.append((state[f"blocks.{i}.{j}.mamba.norm.w"],
                          tree["blocks"]["mamba"]["norm"]["w"][i, j]))
    for i in range(n_tail):
        pairs += [(state[f"tail.{i}.mamba.out"],
                   tree["tail"]["mamba"]["out"][i]),
                  (state[f"tail.{i}.norm.w"], tree["tail"]["norm"]["w"][i])]
    # embed, final norm, 9 shared-attention leaves, 14 leaves per block
    n_entries = 2 + 9 + (n_super * every + n_tail) * 14
    return pairs, n_entries


def _ssm_pairs(state, tree):
    """Sample (port tensor, JAX leaf) pairs of the xLSTM tree:
    blocks.mlstm stacked over (n_super, slstm_every - 1), blocks.slstm over
    n_super."""
    mlstm, slstm = tree["blocks"]["mlstm"], tree["blocks"]["slstm"]
    n_super, n_m = mlstm["wq"].shape[:2]
    pairs = []
    for i in range(n_super):
        for j in range(n_m):
            pairs += [(state[f"blocks.mlstm.{i}.{j}.{k}"], mlstm[k][i, j])
                      for k in ("wq", "conv", "w_if", "if_bias", "w_down")]
            pairs += [(state[f"blocks.mlstm.{i}.{j}.norm.b"],
                       mlstm["norm"]["b"][i, j]),
                      (state[f"blocks.mlstm.{i}.{j}.onorm.w"],
                       mlstm["onorm"]["w"][i, j])]
        pairs += [(state[f"blocks.slstm.{i}.{k}"], slstm[k][i])
                  for k in ("w_in", "gate_bias", "r_w", "w_out")]
        pairs.append((state[f"blocks.slstm.{i}.norm.w"],
                      slstm["norm"]["w"][i]))
    # embed, final norm (w, b); 12 leaves per mLSTM block, 7 per sLSTM
    return pairs, 3 + n_super * (n_m * 12 + 7)


def _dense_pairs(state, tree):
    n_layers = tree["blocks"]["attn"]["wq"].shape[0]
    pairs = []
    for i in range(n_layers):
        pairs += [(state[f"blocks.{i}.attn.wq"],
                   tree["blocks"]["attn"]["wq"][i]),
                  (state[f"blocks.{i}.ffn.w_gate"],
                   tree["blocks"]["ffn"]["w_gate"][i]),
                  (state[f"blocks.{i}.ffn_norm.w"],
                   tree["blocks"]["ffn_norm"]["w"][i])]
    return pairs, 2 + n_layers * 9                # embed, final norm


@pytest.mark.parametrize("arch", [ARCH, "zamba2-1.2b", "xlstm-125m"])
def test_params_from_jax_bit_exact(arch):
    jcfg = jax_reduced_config(jax_get_config(arch))
    params = jax_build_model(jcfg, remat=False).init(jax.random.key(3))
    cfg = reduced_config(get_config(arch))
    for dtype in (jnp.bfloat16, jnp.float32):
        tree = jax.tree.map(np.asarray, _cast(params, dtype))
        state = params_from_jax(tree, cfg.family)
        pairs, n_entries = {"dense": _dense_pairs,
                            "hybrid": _hybrid_pairs,
                            "ssm": _ssm_pairs}[cfg.family](state, tree)
        assert len(state) == n_entries
        pairs += [(state["embed"], tree["embed"]),
                  (state["final_norm.w"], tree["final_norm"]["w"])]
        for t, a in pairs:
            assert tuple(t.shape) == a.shape
            if a.dtype.name == "bfloat16":
                assert t.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    t.view(torch.int16).numpy(), a.view(np.int16))
            else:
                assert t.dtype == torch.float32
                np.testing.assert_array_equal(t.numpy(), a)
        # and the model takes every entry, with nothing missing
        tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
        model = build_model(cfg, device="cpu", dtype=tdtype, seed=None)
        model.load_state_dict(state)


def _forward_pair(jax_side, jdtype, tdtype):
    model, params = jax_side
    params = _cast(params, jdtype)
    toks = _tokens()
    a, _ = jax.jit(model.forward_logits)(
        params, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        b = _port(params, tdtype).forward_logits(torch.from_numpy(toks))
    assert b.dtype == torch.float32 and b.shape == a.shape
    return np.asarray(a), b.numpy()


def test_forward_logits_f32(jax_side):
    """Same algorithm in f32: only summation order differs."""
    a, b = _forward_pair(jax_side, jnp.float32, torch.float32)
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def test_forward_logits_bf16(jax_side):
    """bf16 rounds at other places in the two frameworks: the bound of
    tests/test_decode_consistency.py (quantile, max, top-1)."""
    a, b = _forward_pair(jax_side, jnp.bfloat16, torch.bfloat16)
    diff = np.abs(a - b)
    assert float(np.quantile(diff, 0.999)) < 0.2
    assert float(diff.max()) < 0.5
    assert (a.argmax(-1) == b.argmax(-1)).mean() > 0.9


@pytest.mark.parametrize("jdtype,tdtype,atol", [
    # the KV cache is bf16 on both sides: a 1-ulp f32 difference in a new
    # K/V entry can round to the neighbouring bf16 value, ~4e-3 relative
    (jnp.float32, torch.float32, 2e-3),
    (jnp.bfloat16, torch.bfloat16, 5e-2),
])
def test_decode_step_teacher_forced(jax_side, jdtype, tdtype, atol):
    model, params = jax_side
    params = _cast(params, jdtype)
    port = _port(params, tdtype)
    toks = _tokens(1)
    cache, tcache = model.init_cache(B, S), port.init_cache(B, S)
    assert tcache["k"].dtype == torch.bfloat16
    step = jax.jit(model.decode_step)
    for t in range(S):
        la, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1],
                                                    jnp.int32), jnp.int32(t))
        with torch.no_grad():
            lb, tcache = port.decode_step(
                tcache, torch.from_numpy(toks[:, t:t + 1]), t)
        la = np.asarray(la)
        np.testing.assert_allclose(lb.numpy(), la, rtol=0, atol=atol,
                                   err_msg=f"step {t}")


def test_decode_matches_prefill_forward():
    """The port's own consistency check, as tests/test_decode_consistency.py
    makes it for the JAX package."""
    port = build_model(reduced_config(get_config(ARCH)), device="cpu",
                       seed=3)
    toks = torch.from_numpy(_tokens(2))
    with torch.no_grad():
        full = port.forward_logits(toks)
        cache = port.init_cache(B, S)
        dec = torch.cat([port.decode_step(cache, toks[:, t:t + 1], t)[0]
                         for t in range(S)], dim=1)
    diff = (full - dec).abs().numpy()
    assert float(np.quantile(diff, 0.999)) < 0.2
    assert float(diff.max()) < 0.5
    assert (full.argmax(-1) == dec.argmax(-1)).float().mean() > 0.9
