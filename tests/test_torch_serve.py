"""The port's BatchedServer against the JAX package's on the request set of
examples/serve_decode.py: 6 requests, max_batch 4, max_seq 64, for the
dense, the hybrid and the xLSTM model (slots are reused: a request that
takes over a slot carries on from the previous occupant's recurrent
states, as in the reference).

Both sides run the same weights cast to f32, so greedy tokens can be held
equal; the KV caches (and the conv states) stay bf16 on both sides, as the
JAX package makes them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.registry import build_model as jax_build_model
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduced_config as jax_reduced_config
from repro.serve import BatchedServer as JaxServer
from repro.serve import Request as JaxRequest
from repro_torch.convert import params_from_jax
from repro_torch.models.registry import build_model, get_config, \
    reduced_config
from repro_torch.serve import BatchedServer, Request, make_prefill_step


def _requests(vocab):
    rng = np.random.default_rng(0)
    return [(rid, rng.integers(1, vocab, size=rng.integers(3, 8))
             .astype(np.int32)) for rid in range(6)]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b",
                                  "xlstm-125m"])
def test_batched_server_tokens_equal_reference(arch):
    jcfg = jax_reduced_config(jax_get_config(arch))
    jmodel = jax_build_model(jcfg, remat=False)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jmodel.init(jax.random.key(0)))
    ref = JaxServer(jmodel, params, max_batch=4, max_seq=64)
    # the JAX xLSTM's init_cache gives its sLSTM leaves one shared zero
    # array, which the server's donating step refuses to take twice: the
    # same values in distinct buffers
    ref.cache = jax.tree.map(jnp.array, ref.cache)
    for rid, prompt in _requests(jcfg.vocab_size):
        ref.submit(JaxRequest(rid, prompt, max_new=8))
    ref.run_until_drained()

    cfg = reduced_config(get_config(arch))
    model = build_model(cfg, device="cpu", dtype=torch.float32, seed=None)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          cfg.family))
    server = BatchedServer(model, max_batch=4, max_seq=64, device="cpu")
    bf16_cache = {"dense": server.cache.get("k"),
                  "hybrid": server.cache.get("attn_k"),
                  "ssm": server.cache.get("mlstm", {}).get("conv")}
    assert bf16_cache[cfg.family].dtype == torch.bfloat16
    for rid, prompt in _requests(jcfg.vocab_size):
        server.submit(Request(rid, prompt, max_new=8))
    server.run_until_drained()

    assert len(ref.completed) == 6
    assert [r.rid for r in server.completed] == [r.rid for r in ref.completed]
    assert server.pos == ref.pos
    for ours, theirs in zip(server.completed, ref.completed):
        assert ours.out == theirs.out, ours.rid


def test_server_stops_at_max_seq_like_reference():
    """run_until_drained stops silently at pos >= max_seq - 1, leaving
    unfinished requests in their slots (a reference quirk kept as is)."""
    model = build_model(reduced_config(get_config("llama3.2-1b")),
                        device="cpu", seed=0)
    server = BatchedServer(model, max_batch=2, max_seq=8, device="cpu")
    server.submit(Request(0, np.arange(1, 6, dtype=np.int32), max_new=16))
    server.run_until_drained()
    assert server.pos == 7 and not server.completed
    assert len(server.slots[0].out) == 3


def test_prefill_step_shape_and_dtype():
    model = build_model(reduced_config(get_config("llama3.2-1b")),
                        device="cpu", seed=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 8)))
    logits = make_prefill_step(model, device="cpu")(toks)
    assert logits.shape == (2, 8, 512) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
